"""JPEG round trip as tensor ops.

Port of `image_restoration_tpu/utils/diffjpeg.py`: the same quantization
tables, 2×2 mean chroma subsampling, 8×8 DCT as one contraction with a
(8, 8, 8, 8) basis, nearest chroma upsampling, and
diff_round(x) = round(x) + (x - round(x))³. Per-sample quality factors, so
the degradation chain compresses a whole batch on the device.
`torch.round`, like `jnp.round`, rounds half to even.
Input NHWC RGB in [0, 1]; output the same, clipped.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .device import DeviceConstants

Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32).T

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]],
                           dtype=np.float32).T

_DCT = np.zeros((8, 8, 8, 8), dtype=np.float32)
for _x, _y, _u, _v in itertools.product(range(8), repeat=4):
    _DCT[_x, _y, _u, _v] = (np.cos((2 * _x + 1) * _u * np.pi / 16) *
                            np.cos((2 * _y + 1) * _v * np.pi / 16))
_ALPHA = np.array([1.0 / np.sqrt(2)] + [1] * 7, dtype=np.float32)
_DCT_SCALE = np.outer(_ALPHA, _ALPHA) * 0.25

_RGB2YCBCR = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], dtype=np.float32).T
_YCBCR2RGB = np.array([[1.0, 0.0, 1.402],
                       [1.0, -0.344136, -0.714136],
                       [1.0, 1.772, 0.0]], dtype=np.float32).T

_HOST = {"dct": _DCT, "dct_scale": _DCT_SCALE,
         "alpha2": np.outer(_ALPHA, _ALPHA).astype(np.float32),
         "rgb2ycbcr": _RGB2YCBCR, "ycbcr2rgb": _YCBCR2RGB,
         "y_table": Y_TABLE, "c_table": C_TABLE,
         "ycbcr_offset": np.array([0.0, 128.0, 128.0], np.float32)}


def _build(name, device, dtype):
    return torch.as_tensor(_HOST[name], device=device).to(dtype)


_const = DeviceConstants(_build, maxsize=32)


def diff_round(x):
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality) -> torch.Tensor:
    """Quality ∈ (0, 100] (scalar or tensor) → quant-table factor."""
    q = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - q * 2.0) / 100.0


def _to_blocks(x):
    """(N, H, W) → (N, H/8·W/8, 8, 8)"""
    n, h, w = x.shape
    x = x.reshape(n, h // 8, 8, w // 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(n, -1, 8, 8)


def _from_blocks(x, h, w):
    n = x.shape[0]
    x = x.reshape(n, h // 8, w // 8, 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(n, h, w)


def _dct(blocks):
    t = _const("dct", blocks.device, blocks.dtype)
    scale = _const("dct_scale", blocks.device, blocks.dtype)
    return scale * torch.einsum("nbxy,xyuv->nbuv", blocks - 128.0, t)


def _idct(blocks):
    t = _const("dct", blocks.device, blocks.dtype)
    a = _const("alpha2", blocks.device, blocks.dtype)
    return 0.25 * torch.einsum("nbuv,xyuv->nbxy", blocks * a, t) + 128.0


def diff_jpeg(x: torch.Tensor, quality,
              differentiable: bool = True) -> torch.Tensor:
    """JPEG round trip. x: (N, H, W, 3) RGB [0, 1]; quality: scalar or (N,)."""
    rounding = diff_round if differentiable else torch.round
    n, h, w, _ = x.shape
    h_pad = (16 - h % 16) % 16
    w_pad = (16 - w % 16) % 16
    x = torch.nn.functional.pad(x, (0, 0, 0, w_pad, 0, h_pad))
    hp, wp = h + h_pad, w + w_pad
    dev, dt = x.device, x.dtype

    factor = quality_to_factor(torch.as_tensor(quality, device=dev))
    factor = torch.broadcast_to(torch.atleast_1d(factor), (n,)).to(dt)
    f = factor[:, None, None, None]

    img255 = x * 255.0
    ycbcr = img255 @ _const("rgb2ycbcr", dev, dt) + _const("ycbcr_offset",
                                                            dev, dt)
    y = ycbcr[..., 0]
    cb = ycbcr[..., 1].reshape(n, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))
    cr = ycbcr[..., 2].reshape(n, hp // 2, 2, wp // 2, 2).mean(dim=(2, 4))

    y_tab = _const("y_table", dev, dt)
    c_tab = _const("c_table", dev, dt)
    yq = rounding(_dct(_to_blocks(y)) / (y_tab * f))
    cbq = rounding(_dct(_to_blocks(cb)) / (c_tab * f))
    crq = rounding(_dct(_to_blocks(cr)) / (c_tab * f))

    y2 = _from_blocks(_idct(yq * (y_tab * f)), hp, wp)
    cb2 = _from_blocks(_idct(cbq * (c_tab * f)), hp // 2, wp // 2)
    cr2 = _from_blocks(_idct(crq * (c_tab * f)), hp // 2, wp // 2)
    cb2 = cb2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cr2 = cr2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    ycbcr2 = torch.stack([y2, cb2, cr2], dim=-1) - _const("ycbcr_offset",
                                                          dev, dt)
    rgb = ycbcr2 @ _const("ycbcr2rgb", dev, dt)
    rgb = torch.clamp(rgb, 0.0, 255.0) / 255.0
    return rgb[:, :h, :w, :]
