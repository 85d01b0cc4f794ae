"""Frozen counts of GFPGANv1OCR at the configuration's widths.

`FLOPS_PER_IMAGE` is `torch.utils.flop_counter`'s count of the plain
reference's forward (`reference/gfpgan_ocr_256.py`) for one 256² image:
every convolution as 2·MACs (a transposed conv by PyTorch's formula, the
MACs it does; a depthwise FIR conv by its own MACs) and the style linear.
Elementwise work and the ×2 bilinear upsample are not counted. The test
`benchmark/tests/test_portbench_counts.py` counts it again.

`k1_bytes` is what the forward's fused bias + LeakyReLU sites (kernel
K1's work: `√2·lrelu(x + b)` over (M, C)) need at the least: x read once,
y written once, in float32, and each site's bias read once per forward.
"""

from __future__ import annotations

import math

FLOPS_PER_IMAGE = 34_636_928_000
BYTES_PER_ELEMENT = 4  # float32


def _channels(net: dict, unet: bool) -> dict:
    n = net.get("narrow", 1.0) * (0.5 if unet else 1.0)
    cm = net["channel_multiplier"]
    return {4: int(512 * n), 8: int(512 * n), 16: int(512 * n),
            32: int(512 * n), 64: int(256 * cm * n), 128: int(128 * cm * n),
            256: int(64 * cm * n), 512: int(32 * cm * n),
            1024: int(16 * cm * n)}


def k1_sites(net: dict) -> list:
    """(height, width, channels) of every fused-activation site of one
    image's forward, in order (39 at 256²)."""
    ls = int(math.log2(min(net["input_width"], net["input_height"])))
    r = net["input_width"] // net["input_height"]
    ch, dch = _channels(net, True), _channels(net, False)
    sites = [(2 ** ls, 2 ** ls * r, ch[2 ** ls])]          # conv_body_first
    cin = ch[2 ** ls]
    for i in range(ls, 2, -1):                              # ResBlocks
        sites.append((2 ** i, 2 ** i * r, cin))             # conv1
        cin = ch[2 ** (i - 1)]
        sites.append((2 ** (i - 1), 2 ** (i - 1) * r, cin))  # conv2 ↓
    sites.append((4, 4 * r, ch[4]))                         # final_conv
    cin = ch[4]
    for i in range(3, ls + 1):                              # ResUpBlocks
        sites.append((2 ** (i - 1), 2 ** (i - 1) * r, cin))  # conv1
        cin = ch[2 ** i]
        sites.append((2 ** i, 2 ** i * r, cin))             # conv2 ↑
    sites.append((4, 4 * r, dch[4]))                        # style_conv1
    for i in range(3, ls + 1):                              # style convs
        sites += [(2 ** i, 2 ** i * r, dch[2 ** i])] * 2
    return sites


def k1_bytes(net: dict, images: int, forwards: int) -> int:
    """Least bytes K1 moves over `images` images in `forwards` forwards."""
    sites = k1_sites(net)
    per_image = sum(2 * h * w * c for h, w, c in sites)
    per_forward = sum(c for _, _, c in sites)
    return (images * per_image + forwards * per_forward) * BYTES_PER_ELEMENT
