"""The GFPGAN forward's share of the H100's dense TF32 peak while the
device works: the frozen FLOPs of the plain forward
(counts/gfpgan_ocr_256.py) of the images restored by the traced
stretch's whole calls, over the seconds in which the device was busy in
it (the trace's device time, not the host clock, which the profiler
slows), over 495 TFLOP/s. Idle time is `idle.restore_batch`'s."""

from benchmark.harness.readers import per_busy_second


def read(rec):
    rate = per_busy_second(rec, "answers")
    if rate is None:
        return None
    return 100.0 * rec["counts"].FLOPS_PER_IMAGE * rate / \
        rec["peaks"]["tf32_flops"]
