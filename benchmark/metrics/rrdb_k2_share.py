"""Kernel K2's share of the busy device time of the traced window: the
device time of the kernel named below over the union of every kernel,
copy and set."""

from benchmark.harness.readers import kernel_seconds

KERNEL = "int8_conv3x3_wgmma"


def read(rec):
    t = kernel_seconds(rec, KERNEL)
    if not t or not rec.get("busy_s"):
        return None
    return 100.0 * t / rec["busy_s"]
