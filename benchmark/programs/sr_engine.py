"""`EngineRestorer` over `serve.sr_engine.build_engine` with the
configuration's `network` and `engine` options. The seeded weights go in
through the engine's own `pth=` path (a file under TMPDIR, removed once
built) and the seeded calibration batch as `calib=`; the reference works
the activation scales and the quantized weights out again from both."""

import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark.harness.weights import smooth_images


def calibration(cfg: dict, seed: int, device) -> torch.Tensor:
    """The seeded calibration batch, (N, H, W, 3) float [0, 1]."""
    c = cfg["calibration"]
    return smooth_images(c["n"], c["height"], c["width"], seed, "calib",
                         device).float() / 255.0


def build(spec, params, seed, device):
    from image_restoration_tpu_torch.serve.engine_restorer import \
        EngineRestorer

    cfg = spec.config
    calib = calibration(cfg, seed, device).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="bench_w_") as tmp:
        pth = Path(tmp) / "weights.pth"
        torch.save({"params": {k: v.cpu() for k, v in params.items()}}, pth)
        return EngineRestorer.build(**cfg["network"], **cfg["engine"],
                                    pth=str(pth), calib=calib, device=device)


class Reference:
    """An `EngineRestorer`'s `__call__` (RGB uint8 → ×r RGB uint8),
    computed by the reference module at the configuration's bits or the
    control's."""

    def __init__(self, spec, params, seed, device, control: bool):
        cfg = spec.config
        ref = spec.reference
        bits = cfg["control"]["bits"] if control else cfg["bits"]
        scales = ref.calibrate(params, cfg["network"],
                               calibration(cfg, seed, device))
        self.q = ref.quantize(params, cfg["network"], scales, bits=bits)
        self.ref, self.engine, self.device = ref, cfg["engine"], device

    def __call__(self, img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return self.ref.restore_u8(self.q, x, self.engine["tile"],
                                   self.engine["halo"]).cpu().numpy()


def reference(spec, params, seed, device, control=False):
    return Reference(spec, params, seed, device, control)
