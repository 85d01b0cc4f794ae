"""Quantization-aware training (QAT) of the int8 SRVGG serving path.

Port of `image_restoration_tpu/ops/qat.py` (whole). The fake-quant forward
of SRVGGNetCompact follows the served int8 graph
(`ops/quantized_inference.py`) point for point:

  * the input quantized with scale s_0;
  * every body conv with symmetric per-output-channel weights (a
    straight-through estimator), bias and PReLU in float, then the next
    conv's input requantized with s_{i+1};
  * conv_last an int8 sink: its residual output quantized with s_last;
  * the nearest-upsampled base and the pixel shuffle in float.

The activation scales are exponential moving averages of |max| at each
quantization point (`update_qscale`), carried by the trainer
(`SRModel.qscale`); a scale not yet observed (0) falls back to the batch's
own |max|. `export_int8` turns a trained net and its scales into the
serving weights of `quantize_srvgg_params`, whose 34 int8 convs (at 32
body convs) run kernel K2.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from .pixel_ops import pixel_shuffle
from .quantized_inference import quantize_srvgg_params


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the value of q, the gradient of x."""
    return x + (q - x).detach()


def fake_quant_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 fake-quant with one scale (the |max| domain): the
    tensor's own |max| while `scale` is 0. The gradient passes only inside
    the band ±127·s: a clipped element forwards the band edge and gets no
    gradient (a plain round with `detach` would pass one)."""
    dyn = x.detach().abs().max() + 1e-12
    s = torch.where(scale > 0, scale, dyn) / 127.0
    q = torch.clamp(torch.round(x / s), -127, 127) * s
    in_band = x.abs() <= 127.0 * s
    return torch.where(in_band, _ste(x, q), q.detach())


def fake_quant_weight(w: torch.Tensor, qmax: int = 127) -> torch.Tensor:
    """Per-output-channel symmetric fake-quant of an OIHW weight (the
    scheme of `quantize_srvgg_params` at qmax 127); qmax 7 trains 4-bit
    weights."""
    w_scale = w.detach().abs().amax(dim=(1, 2, 3), keepdim=True) / qmax
    w_scale = w_scale + 1e-12
    q = torch.clamp(torch.round(w / w_scale), -qmax, qmax) * w_scale
    return _ste(w, q)


def _conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(h.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return y + b


def qat_srvgg_forward(net, x: torch.Tensor, qscale: torch.Tensor,
                      weight_qmax: int = 127
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fake-quant forward of `net` (an SRVGGNetCompact with PReLU).

    x: (N, H, W, 3) in [0, 1]; qscale: (num_conv + 3,) tracked |max|
    scales, indexed as `calibrate_srvgg_act_scales`'s (each conv's input,
    conv_last's input, conv_last's output). Returns (output (N, H·r, W·r,
    3), this batch's |max| at each quantization point, detached)."""
    qscale = qscale.detach()
    layers = net.conv_layers()
    num_conv = len(layers) - 2
    maxima = []
    h = x
    for i, (w, b, a) in enumerate(layers[:-1]):
        maxima.append(h.detach().abs().max())
        h = fake_quant_act(h, qscale[i])
        h = _conv(h, fake_quant_weight(w, weight_qmax), b)
        h = torch.where(h >= 0, h, h * a)
    maxima.append(h.detach().abs().max())
    h = fake_quant_act(h, qscale[num_conv + 1])
    w, b, _ = layers[-1]
    out = _conv(h, fake_quant_weight(w, weight_qmax), b)
    maxima.append(out.detach().abs().max())
    out = fake_quant_act(out, qscale[num_conv + 2])
    r = net.upscale
    out = pixel_shuffle(out, r)
    base = x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
    return out + base, torch.stack(maxima)


def update_qscale(qscale: torch.Tensor, batch_max: torch.Tensor,
                  decay: float = 0.99) -> torch.Tensor:
    """The EMA of the activation maxima; a scale still at 0 takes the
    batch's max outright."""
    ema = decay * qscale + (1.0 - decay) * batch_max
    return torch.where(qscale > 0, ema, batch_max)


def export_int8(net, qscale: Sequence[float] | torch.Tensor,
                pack: int = 2) -> Dict[str, torch.Tensor]:
    """A QAT net and its scales → the serving weights that
    `quantized_srvgg_forward` takes (the PTQ export, with the trained scales
    in place of a calibration batch)."""
    scales = [float(s) for s in torch.as_tensor(qscale).tolist()]
    if min(scales) <= 0.0:
        raise ValueError(
            f"qscale contains untrained (<= 0) activation scales {scales}: "
            "run at least one optimize_parameters step with train.quant_opt "
            "before exporting (the EMA scales are only observed during "
            "training)")
    return quantize_srvgg_params(net, scales, pack=pack)
