"""The RRDB engine's share of the H100's dense peaks while the device
works: the least time of the model's work on the real tiles served by the
traced stretch's whole calls (counts/rrdbnet_x4plus_int8.py: the int8
operations of the 345 stage convs at 1,979 TOP/s plus the bfloat16 FLOPs
of the six head and tail convs at 989 TFLOP/s), over the seconds in which
the device was busy in it (the trace's device time, copies included).
Zero padding tiles do not count. Idle time is `idle.rrdb`'s."""

from benchmark.harness.readers import per_busy_second


def read(rec):
    rate = per_busy_second(rec, "real_tiles")
    if rate is None:
        return None
    cfg = rec["config"]
    return 100.0 * rate * rec["counts"].least_s_per_tile(
        cfg["network"], cfg["engine"], rec["peaks"])
