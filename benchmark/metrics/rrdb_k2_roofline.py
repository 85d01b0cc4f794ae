"""Kernel K2 `irt::int8_conv3x3_requant` (csrc/int8_conv3x3.cu, "bf16_deq"
epilogue) at RRDB's stage shapes against its roofline: for the tiles of
the traced stretch's engine calls, each launch's least time (the larger of
its int8 operations at 1,979 TOP/s and its bytes at 3.35 TB/s;
counts/rrdbnet_x4plus_int8.py), summed, over the device time of the kernel
named below. The tiles are those the driver handed to the engine, padding
included, each of which the forward counts in the program's counter
`rrdb.tiles`: without that counter, or with fewer tiles in it than the
window handed over, the program served them some other way and the metric
reads nothing."""

from benchmark.harness.readers import kernel_seconds
from benchmark.harness.spans import counters

KERNEL = "int8_conv3x3_wgmma"


def read(rec):
    t = kernel_seconds(rec, KERNEL)
    traced = rec.get("traced")
    ran = counters().get("rrdb.tiles")
    if not t or not traced or ran is None \
            or ran < rec["work"].get("engine_tiles", 0):
        return None
    cfg = rec["config"]
    least = rec["counts"].k2_least_s(cfg["network"], cfg["engine"],
                                      traced["engine_tiles"],
                                      traced["engine_calls"], rec["peaks"])
    return 100.0 * least / t
