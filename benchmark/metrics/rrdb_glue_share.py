"""The share of the traced window's busy device time in PyTorch's
elementwise kernels: between K2's launches, the bfloat16 slice sums,
LeakyReLU, the requantization to int8 and the residuals; also, a small
part, the tail's bias adds and activations and the uint8 IO's casts."""

from benchmark.harness.readers import kernel_seconds

GLUE = "elementwise_kernel"


def read(rec):
    t = kernel_seconds(rec, GLUE)
    if not t or not rec.get("busy_s"):
        return None
    return 100.0 * t / rec["busy_s"]
