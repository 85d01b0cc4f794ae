"""Serve the ×4 SR tile engine on images of any size.

Port of `EngineRestorer` (`image_restoration_tpu/serve/engine_restorer.py:
121-157`): the image goes through the halo tiler with `tile_batch` equal to
the engine's batch, so every engine call sees its frozen shape (the tiler
reflect-pads the grid and zero-pads the last chunk). The engine is built in
process (`serve/sr_engine.py`); loading one from a directory waits for
`torch.export`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.tiling import tiled_apply
from ..utils.device import resolve_device
from .sr_engine import build_engine


class EngineRestorer:
    """Callable: RGB (H, W, 3), uint8 [0, 255] or float [0, 1] → uint8 RGB
    ×upscale. The engine takes uint8 tiles on the device and returns uint8;
    float input is rounded to uint8 first."""

    def __init__(self, serve, meta: dict):
        self.serve, self.meta = serve, meta
        self.tile = int(meta["tile"])
        self.halo = int(meta["halo"])
        self.batch = int(meta["batch"])
        self.upscale = int(meta["upscale"])
        self.device = resolve_device(meta["device"])

    @classmethod
    def build(cls, **kwargs) -> "EngineRestorer":
        """An engine from `build_engine(**kwargs)`."""
        return cls(*build_engine(**kwargs))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.dtype != np.uint8:
            img = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5,
                          0, 255).astype(np.uint8)
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        out = tiled_apply(self.serve, x[None], tile=self.tile,
                          halo=self.halo, scale=self.upscale,
                          tile_batch=self.batch)
        return out[0].cpu().numpy()
