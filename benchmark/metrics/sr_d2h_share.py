"""Share of the traced window in device-to-host copies (the ×4 output's
way back to the caller)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * rec["dtoh_s"] / rec["window_s"]
