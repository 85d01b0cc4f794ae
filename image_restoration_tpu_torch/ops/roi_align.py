"""RoIAlign over NHWC batches, differentiable in the image.

Port of `image_restoration_tpu/ops/roi_align.py:84-151` (torchvision's
semantics with ``aligned=False``), the crops of the per-char boxes that
the component discriminators see:

  * rois are half-open [x1, y1, x2, y2] in input pixels (times
    ``spatial_scale``), width and height clamped to >= 1 px;
  * each of the S×S output bins averages ``sampling_ratio²`` bilinear
    samples at the centres of a regular sub-grid (the ratio is fixed, not
    torchvision's adaptive −1);
  * a sample outside [−1, H] or [−1, W] contributes 0; one inside is
    interpolated with its coordinates clamped to the edge.

The bilinear blend of a sample lattice is separable, and so is the mask
and the bin average, so a crop is ``Ay · img · Axᵀ`` with Ay (S, H) and Ax
(S, W) holding, for each output row and column, the averaged two-tap
interpolation weights. The two products are plain matmuls on the device,
and the gradient to the image (the G loss backpropagates through the fake
crops) is their transpose. The boxes are data: no gradient reaches them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _axis_weights(lo: torch.Tensor, bin_len: torch.Tensor, size: int,
                  s: int, sr: int) -> torch.Tensor:
    """(N, K, S, size) weights of one axis: row i averages the sr samples
    of bin i, each split between its two clamped neighbours, zero where
    the sample lies outside [−1, size]."""
    grid = (torch.arange(s * sr, dtype=torch.float32, device=lo.device)
            + 0.5) / sr
    pos = lo[..., None] + bin_len[..., None] * grid        # (N, K, S·sr)
    valid = (pos >= -1.0) & (pos <= float(size))
    p = pos.clamp(0.0, size - 1.0)
    p0 = p.floor()
    frac = p - p0
    i0 = p0.long()
    i1 = (i0 + 1).clamp(max=size - 1)
    w = ((1.0 - frac)[..., None] * F.one_hot(i0, size)
         + frac[..., None] * F.one_hot(i1, size))
    w = w * valid[..., None]
    return w.reshape(*w.shape[:2], s, sr, size).mean(dim=3)


def roi_align(images: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Batched RoIAlign.

    Args:
      images: (N, H, W, C).
      boxes: (N, K, 4) rois [x1, y1, x2, y2] per image, in pixels before
        ``spatial_scale``.
      output_size: S; crops are S × S.
      sampling_ratio: samples per bin edge.

    Returns:
      (N, K, S, S, C) crops in the dtype of ``images`` (computed in
      float32).
    """
    n, h, w, c = images.shape
    s, sr = int(output_size), int(sampling_ratio)
    b = boxes.to(device=images.device, dtype=torch.float32).detach() \
        * spatial_scale
    x1, y1, x2, y2 = b.unbind(-1)
    roi_w = (x2 - x1).clamp(min=1.0)
    roi_h = (y2 - y1).clamp(min=1.0)
    ay = _axis_weights(y1, roi_h / s, h, s, sr)            # (N, K, S, H)
    ax = _axis_weights(x1, roi_w / s, w, s, sr)            # (N, K, S, W)
    img = images.to(torch.float32)
    rows = torch.einsum("nksh,nhwc->nkswc", ay, img)
    crops = torch.einsum("nkswc,nktw->nkstc", rows, ax)
    return crops.to(images.dtype)
