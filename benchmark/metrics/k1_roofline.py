"""Kernel K1 `irt::fused_bias_lrelu` (csrc/fused_bias_act.cu) against its
roofline: the least time of the bytes its 39 sites a forward need
(counts/gfpgan_ocr_256.py) over HBM's 3.35 TB/s, for the forwards of the
traced window, over the device time of the kernels named below."""

from benchmark.harness.readers import kernel_seconds

KERNEL = "fused_bias_lrelu"  # fused_bias_lrelu_vec16 / _scalar


def read(rec):
    t = kernel_seconds(rec, KERNEL)
    traced = rec.get("traced")
    if not t or not traced:
        return None
    nbytes = rec["counts"].k1_bytes(rec["config"]["network"],
                                    traced["answers"], traced["calls"])
    return 100.0 * nbytes / rec["peaks"]["hbm_bytes"] / t
