"""Anchor (prior box) generation — a copy of
`image_restoration_tpu/detect/priors.py:15-43`, numpy and float32, which
mirrors the reference Plate_Detect/Retina-License-Plate/layers/functions/
prior_box.py:7-34. Computed once when a detector is built; 224² gives 2,058
priors.
"""

from __future__ import annotations

import math

import numpy as np


def prior_box(cfg: dict, image_size) -> np.ndarray:
    """(num_priors, 4) anchors in (cx, cy, w, h), normalized coords."""
    min_sizes_list = cfg["min_sizes"]
    steps = cfg["steps"]
    ih, iw = image_size
    anchors = []
    for k, step in enumerate(steps):
        fh = math.ceil(ih / step)
        fw = math.ceil(iw / step)
        ii, jj = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
        cx = (jj + 0.5) * step / iw
        cy = (ii + 0.5) * step / ih
        for min_size in min_sizes_list[k]:
            s_kx = min_size / iw
            s_ky = min_size / ih
            a = np.stack([cx, cy, np.full_like(cx, s_kx, dtype=np.float64),
                          np.full_like(cy, s_ky, dtype=np.float64)], axis=-1)
            anchors.append(a.reshape(fh, fw, 1, 4))
    # interleave min_sizes per location like the reference product() order
    out = []
    for k, step in enumerate(steps):
        per = [anchors.pop(0) for _ in cfg["min_sizes"][k]]
        out.append(np.concatenate(per, axis=2).reshape(-1, 4))
    priors = np.concatenate(out, axis=0).astype(np.float32)
    if cfg.get("clip"):
        priors = np.clip(priors, 0, 1)
    return priors
