"""cuDNN's bf16 conv against kernel K3 at the widened-RRDB stage shapes, 528².

    python -m image_restoration_tpu_torch.scripts.probe_conv [--device cuda]

The counterpart of `scripts/probe_pallas_conv.py`: for each of its five stage
shapes (Cin → Cout 64 → 192, 32 → 160, 128, 96, 64) on one 528² image, bf16
in and out, it prints cuDNN's conv time and rate, K3's time and rate, and
K3's largest error relative to the conv's largest value, which must stay
below 2e-2. Times are device ms per call, from CUDA events around 20 calls
after a warm-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.im2col_conv import conv3x3_im2col
from ..utils.device import resolve_device

SIZE = 528
ITERS = 20
SHAPES = [
    ("stage1 64->192", 64, 192, 4),
    ("stage2 32->160", 32, 160, 8),
    ("stage3 32->128", 32, 128, 8),
    ("stage4 32->96", 32, 96, 8),
    ("stage5 32->64", 32, 64, 8),
]


def time_ms(fn, device: torch.device) -> float:
    """Mean ms per call of fn() over ITERS calls after 3 warm-up calls:
    CUDA events on the card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        return (time.perf_counter() - t0) * 1e3 / ITERS
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def probe_stage(name: str, x: torch.Tensor, w: torch.Tensor,
                bh: int) -> dict:
    """One stage: x (1, H+2, W+2, Cin) and w (3, 3, Cin, Cout) bf16. Times
    the conv and K3, checks K3 against the conv and prints both rates."""
    device = x.device
    _, hp, wp, cin = x.shape
    cout = w.shape[-1]
    flops = 2 * 9 * cin * cout * (hp - 2) * (wp - 2)
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def conv():
        return F.conv2d(xc, wc)

    ms_conv = time_ms(conv, device)
    ref = conv().permute(0, 2, 3, 1).float()
    got = conv3x3_im2col(x, w, bh=bh).float()
    rel = (ref - got).abs().max().item() / (ref.abs().max().item() or 1.0)
    assert rel < 2e-2, f"{name}: K3 mismatch rel={rel}"
    ms_k3 = time_ms(lambda: conv3x3_im2col(x, w, bh=bh), device)
    lib = "cudnn" if device.type == "cuda" else "cpu"
    print(f"{name:18s} {lib}-bf16: {ms_conv:8.4f} ms "
          f"{flops / ms_conv / 1e9:7.1f} TFLOP/s", flush=True)
    print(f"{name:18s} K3 bh={bh:2d}:   {ms_k3:8.4f} ms "
          f"{flops / ms_k3 / 1e9:7.1f} TFLOP/s (rel err {rel:.1e})",
          flush=True)
    return dict(stage=name, cin=cin, cout=cout, size=hp - 2,
                conv_ms=ms_conv, k3_ms=ms_k3, rel_err=rel,
                conv_tflops=flops / ms_conv / 1e9,
                k3_tflops=flops / ms_k3 / 1e9)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device)
    print(f"device: {name}", flush=True)
    rows = []
    for name, cin, cout, bh in SHAPES:
        x = torch.from_numpy(rng.random((1, SIZE + 2, SIZE + 2, cin),
                                        np.float32)).to(device, torch.bfloat16)
        w = torch.from_numpy(rng.random((3, 3, cin, cout), np.float32)
                             - 0.5).to(device, torch.bfloat16)
        rows.append(probe_stage(name, x, w, bh))
    return rows


if __name__ == "__main__":
    main()
