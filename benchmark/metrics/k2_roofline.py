"""Kernel K2 `irt::int8_conv3x3_requant` (csrc/int8_conv3x3.cu) against
its roofline: the unpacked model's int8 operations and bytes for every
tile the engine computed in the traced window, zero padding tiles
included (counts/srvgg_x4_int8.py), the larger of their least times at
1,979 TOP/s and 3.35 TB/s, over the device time of the kernel named
below."""

from benchmark.harness.readers import kernel_seconds

KERNEL = "int8_conv3x3_wgmma"


def read(rec):
    t = kernel_seconds(rec, KERNEL)
    traced = rec.get("traced")
    if not t or not traced:
        return None
    cfg = rec["config"]
    least = rec["counts"].k2_least_s(cfg["network"], cfg["engine"],
                                      traced["engine_tiles"],
                                      traced["engine_calls"], rec["peaks"])
    return 100.0 * least / t
