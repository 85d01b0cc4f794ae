"""FID: InceptionV3 features on the device, the Fréchet distance on the host.

Port of `image_restoration_tpu/metrics/fid.py:16-83`.
`load_patched_inception_v3` builds the FID InceptionV3 (random weights from
seed 0 unless a pt_inception `.pth` is given) on the device;
`extract_inception_features` runs it over batches of NHWC RGB images in
[0, 1], the one input scale every FID path of the port feeds it; and
`calculate_fid` is the distance between two Gaussians in float64 scipy on
the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.registry import METRIC_REGISTRY


def load_patched_inception_v3(weights_path: Optional[str] = None,
                              device=None) -> torch.nn.Module:
    """The InceptionV3 FID extractor on `device` (None: cuda), in eval
    form: NHWC RGB in [0, 1] → (N, 2048). `weights_path` is a pt_inception
    (torchvision-keyed) `.pth`; its `fc.*` and `AuxLogits.*` are dropped and
    the rest must fill the net."""
    from ..archs import build_network
    dev = resolve_device(device)
    net = build_network(dict(type="InceptionV3"))
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("fc.", "AuxLogits."))}
        net.load_state_dict(sd, strict=True)
    return net.to(dev).eval().requires_grad_(False)


@torch.inference_mode()
def extract_inception_features(data_generator, extract_fn) -> np.ndarray:
    """(N, 2048) float32 features of the batches of `data_generator` (NHWC
    RGB in [0, 1], tensors or numpy arrays), kept on the device until the
    last batch and copied to the host once."""
    dev = next(extract_fn.parameters()).device
    feats = [extract_fn(torch.as_tensor(batch, dtype=torch.float32,
                                        device=dev))
             for batch in data_generator]
    return torch.cat(feats).cpu().numpy()


@METRIC_REGISTRY.register()
def calculate_fid(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between N(mu1, sigma1) and N(mu2, sigma2)."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mean {mu1.shape} / {mu2.shape} or covariance "
                         f"{sigma1.shape} / {sigma2.shape} shapes differ")

    cov_sqrt = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(cov_sqrt).all():
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f"Imaginary component {m}")
        cov_sqrt = cov_sqrt.real

    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(cov_sqrt))
