"""The SR route's share of the H100's dense int8 peak while the device
works: the model's int8 operations (counts/srvgg_x4_int8.py) of the real
tiles served by the traced stretch's whole calls, over the seconds in
which the device was busy in it (the trace's device time, copies
included, not the host clock, which the profiler slows), over 1,979
TOP/s. Zero padding tiles do not count. Idle time is `idle.sr`'s."""

from benchmark.harness.readers import per_busy_second


def read(rec):
    rate = per_busy_second(rec, "real_tiles")
    if rate is None:
        return None
    cfg = rec["config"]
    return 100.0 * rec["counts"].ops_per_tile(cfg["network"], cfg["engine"]) \
        * rate / rec["peaks"]["int8_ops"]
