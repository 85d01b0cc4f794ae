"""Restored images that reached host memory in the window, per second of
it (host clock; the closed batch loop)."""


def read(rec):
    return rec["answers"] / rec["elapsed_s"]
