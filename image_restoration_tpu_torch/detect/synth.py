"""Synthetic plate scenes for detector training, made on the device.

Port of `image_restoration_tpu/detect/synth.py:29-84`: a bright plate-like
rectangle with dark character-like strokes over a smooth noisy background,
and its MultiBox target row (bbox, the reference's 5 landmarks, label 1).

As the degradations do (`data/degradations.py`), a scene is split in two:
`sample_scenes` draws every random number from a `torch.Generator` on the
device (the coarse background grid, the grain, the plate's geometry, value,
stroke frequency and phase), and `render_scenes` is deterministic given
them, so it can be held against JAX's at parameters JAX drew.

Landmark order matches the product pipeline (serve/pipeline.py
`_detect_quad`): p1 = TL, p2 = TR, p3 = centre, p4 = BL, p5 = BR, all in
[0, 1].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sample_scenes(generator: torch.Generator, batch: int, size: int) -> dict:
    """Every random draw of `batch` scenes of size², on the generator's
    device: U(lo, hi) as JAX's `uniform(minval=lo, maxval=hi)`, the grain
    standard normal."""
    dev = generator.device

    def u(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * \
            (hi - lo) + lo

    return dict(
        coarse=u((batch, 8, 8, 3), 30.0, 190.0),
        grain=torch.randn((batch, size, size, 3), generator=generator,
                          device=dev),
        wfrac=u((batch,), 0.25, 0.55),    # plate width, canvas fraction
        aspect=u((batch,), 0.28, 0.45),   # height / width
        ux=u((batch,), 0.03, 1.0),
        uy=u((batch,), 0.03, 1.0),
        plate_val=u((batch,), 190.0, 250.0),
        freq=u((batch,), 5.0, 9.0),
        phase=u((batch,), 0.0, 2.0 * math.pi))


def render_scenes(p: dict, size: int):
    """(B, size, size, 3) BGR [0, 255] scenes and their (B, 15) target rows
    from `sample_scenes`' draws."""
    coarse = p["coarse"]
    # jax.image.resize's bilinear upsample: half-pixel centres, the weights
    # renormalized at the edges, which is clamping, as here
    bg = F.interpolate(coarse.permute(0, 3, 1, 2), size=(size, size),
                       mode="bilinear", align_corners=False)
    bg = bg.permute(0, 2, 3, 1) + p["grain"] * 8.0

    wfrac = p["wfrac"][:, None]
    hfrac = wfrac * p["aspect"][:, None]
    x0 = p["ux"][:, None] * (0.94 - wfrac) + 0.03
    y0 = p["uy"][:, None] * (0.94 - hfrac) + 0.03
    x1, y1 = x0 + wfrac, y0 + hfrac

    fx = (torch.arange(size, dtype=torch.float32, device=coarse.device)
          + 0.5) / size
    fy = fx[None, :]
    fx = fx[None, :]
    inx = (fx >= x0) & (fx < x1)                      # (B, S)
    iny = (fy >= y0) & (fy < y1)
    plate_mask = iny[:, :, None] & inx[:, None, :]    # (B, S, S)

    strokes = torch.sin((fx - x0) / wfrac * p["freq"][:, None] * 2.0
                        * math.pi + p["phase"][:, None]) > 0.2
    inner_y = (fy >= y0 + 0.25 * hfrac) & (fy < y1 - 0.25 * hfrac)
    inner_x = (fx >= x0 + 0.06 * wfrac) & (fx < x1 - 0.06 * wfrac)
    text_mask = (inner_y[:, :, None] & (strokes & inner_x)[:, None, :]
                 & plate_mask)

    img = torch.where(plate_mask[..., None],
                      p["plate_val"][:, None, None, None], bg)
    img = torch.where(text_mask[..., None], torch.full_like(img, 40.0), img)
    img = torch.clamp(img, 0.0, 255.0)

    x0, y0, x1, y1 = x0[:, 0], y0[:, 0], x1[:, 0], y1[:, 0]
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    target = torch.stack([x0, y0, x1, y1,            # bbox
                          x0, y0, x1, y0,            # p1 = TL, p2 = TR
                          cx, cy,                    # p3 = centre
                          x0, y1, x1, y1,            # p4 = BL, p5 = BR
                          torch.ones_like(x0)], -1)  # class: plate
    return img, target


def make_batch(generator: torch.Generator, batch: int, size: int,
               max_targets: int = 4):
    """(batch, size, size, 3) BGR [0, 255] scenes and (batch, max_targets,
    15) MultiBox targets (row 0 real, the rest label-0 padding), on the
    generator's device."""
    imgs, rows = render_scenes(sample_scenes(generator, batch, size), size)
    targets = torch.zeros((batch, max_targets, 15), device=imgs.device)
    targets[:, 0] = rows
    return imgs, targets
