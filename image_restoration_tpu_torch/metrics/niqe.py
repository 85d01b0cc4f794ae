"""NIQE, the no-reference quality metric, in numpy on the host.

Port of `image_restoration_tpu/metrics/niqe.py:31-149` (BasicSR's
`metrics/niqe.py:142-189`): MSCN normalization, AGGD feature fits over
96×96 blocks at two scales, and the Mahalanobis-style distance between the
test image's multivariate Gaussian and the pristine one. The pristine
parameters (mu, cov and the Gaussian window, the published MATLAB-derived
constants) are data and ship with the port at
`metrics/assets/niqe_pris_params.npz`, a copy of the JAX package's;
`params_path` overrides them.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ..utils.registry import METRIC_REGISTRY
from .metric_util import to_y_channel

_DEFAULT_PARAMS = os.path.join(os.path.dirname(__file__), "assets",
                               "niqe_pris_params.npz")

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = None


def _r_gam():
    global _R_GAM
    if _R_GAM is None:
        from scipy.special import gamma
        _R_GAM = (gamma(2.0 / _GAM) ** 2) / (
            gamma(1.0 / _GAM) * gamma(3.0 / _GAM))
    return _R_GAM


def estimate_aggd_param(block: np.ndarray):
    """Estimate AGGD (alpha, beta_l, beta_r) of a coefficient block."""
    from scipy.special import gamma
    block = block.flatten()
    left_std = np.sqrt(np.mean(block[block < 0] ** 2)) if \
        np.any(block < 0) else 1e-6
    right_std = np.sqrt(np.mean(block[block > 0] ** 2)) if \
        np.any(block > 0) else 1e-6
    gammahat = left_std / right_std
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2) if \
        np.mean(block ** 2) > 0 else 1e-6
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    array_position = np.argmin((_r_gam() - rhatnorm) ** 2)
    alpha = _GAM[array_position]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return alpha, beta_l, beta_r


def compute_feature(block: np.ndarray) -> list:
    """18-dim NIQE feature of one MSCN block (AGGD + 4 pairwise products)."""
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    from scipy.special import gamma
    for sh in shifts:
        shifted = np.roll(block, sh, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def _mscn(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    import cv2
    mu = cv2.filter2D(img, -1, window, borderType=cv2.BORDER_REPLICATE)
    sigma = np.sqrt(np.abs(
        cv2.filter2D(img * img, -1, window,
                     borderType=cv2.BORDER_REPLICATE) - mu * mu))
    return (img - mu) / (sigma + 1.0)


def niqe_core(img: np.ndarray, mu_pris_param, cov_pris_param,
              gaussian_window, block_size_h: int = 96,
              block_size_w: int = 96) -> float:
    """NIQE of a [0,255] float64 grayscale image."""
    import cv2
    h, w = img.shape
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    img = img[0:num_block_h * block_size_h, 0:num_block_w * block_size_w]

    distparam = []
    for scale in (1, 2):
        img_norm = _mscn(img, gaussian_window)
        feats = []
        # same block GRID at both scales; the block size halves with the
        # image (ref niqe.py:103-115)
        for i in range(num_block_h):
            for j in range(num_block_w):
                bh, bw = block_size_h // scale, block_size_w // scale
                block = img_norm[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
                feats.append(compute_feature(block))
        distparam.append(np.asarray(feats))
        if scale == 1:
            img = cv2.resize(img / 255.0, (img.shape[1] // 2,
                                           img.shape[0] // 2),
                             interpolation=cv2.INTER_LINEAR) * 255.0

    distparam = np.concatenate(distparam, axis=1)
    mu_distparam = np.nanmean(distparam, axis=0)
    distparam_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(distparam_no_nan, rowvar=False)
    invcov_param = np.linalg.pinv((cov_pris_param + cov_distparam) / 2)
    diff = (mu_pris_param - mu_distparam)[None, :]
    quality = diff @ invcov_param @ diff.T
    return float(np.sqrt(quality[0, 0]))


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border: int, input_order: str = "HWC",
                   convert_to: str = "y",
                   params_path: Optional[str] = None, **kwargs) -> float:
    """NIQE of a [0,255] BGR HWC image (ref niqe.py:142-189)."""
    import cv2
    path = params_path or _DEFAULT_PARAMS
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"NIQE pristine params not found at {path}; pass params_path= "
            "(an .npz with mu_pris_param, cov_pris_param, gaussian_window)")
    niqe_pris_params = np.load(path)
    mu = np.ravel(niqe_pris_params["mu_pris_param"])  # stored (1, 36)
    cov = niqe_pris_params["cov_pris_param"]
    window = niqe_pris_params["gaussian_window"]

    img = np.asarray(img).astype(np.float32)
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if img.ndim == 3 and img.shape[2] == 3:
        if convert_to == "y":
            img = to_y_channel(img)[..., 0]
        else:
            img = cv2.cvtColor(img / 255.0, cv2.COLOR_BGR2GRAY) * 255.0
    elif img.ndim == 3:
        img = img[..., 0]
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe_core(np.round(img).astype(np.float64), mu, cov, window)
