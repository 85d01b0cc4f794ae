"""512² tile-grid cells (gh·gw) of the photos whose ×4 output reached
host memory in the window, per second of it (host clock). The engine's
zero padding tiles do not count."""


def read(rec):
    return rec["real_tiles"] / rec["elapsed_s"]
