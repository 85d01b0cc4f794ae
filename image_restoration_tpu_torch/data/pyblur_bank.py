"""Procedural pyblur kernel bank.

A copy of `image_restoration_tpu/data/pyblur_bank.py` (numpy only; the port
imports nothing of the JAX package), reading the port's own copy of
`assets/psf_bank.npz`.

The reference vendors pyblur twice (SURVEY §2.7): BoxBlur, DefocusBlur (disk
kernels), GaussianBlur, LinearMotionBlur (LineDictionary line kernels at
quantized angles), PsfBlur (100 measured camera-shake PSFs from psf.pkl),
with RandomizedBlur drawing uniformly over four types — all applied by
scipy convolve2d in dataloader workers.

All pyblur kernels become one constant (K, 21, 21) bank generated here at
init, and the degradation chain selects rows by a drawn index —
`random_mixed_kernel`'s `extra_bank`.

The 100 measured camera-shake PSFs ship in-repo as
`assets/psf_bank.npz` — converted from pyblur's psf.pkl (odd sizes 5..29,
each unit-mass; entries wider than 21 carry ALL their mass inside the
central 21×21, so the crop is lossless ≤6e-8). If the asset is missing,
procedurally synthesized random-walk PSFs stand in.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

PAD = 21
MEASURED_PSF_PATH = osp.join(osp.dirname(__file__), "assets",
                             "psf_bank.npz")


def _padded(k: np.ndarray, pad: int = PAD) -> np.ndarray:
    s = k.shape[0]
    out = np.zeros((pad, pad), np.float32)
    o = (pad - s) // 2
    out[o:o + s, o:o + s] = k
    return out / out.sum()


def box_kernels(sizes=(3, 5, 7, 9)) -> list:
    return [_padded(np.ones((s, s), np.float32)) for s in sizes]


def disk_kernels(sizes=(3, 5, 7, 9)) -> list:
    """Defocus (disk) kernels — pyblur DefocusBlur."""
    out = []
    for s in sizes:
        r = (s - 1) / 2
        ax = np.arange(s) - r
        xx, yy = np.meshgrid(ax, ax)
        d = np.sqrt(xx ** 2 + yy ** 2)
        k = np.clip(r + 0.5 - d, 0, 1).astype(np.float32)  # soft disk edge
        out.append(_padded(k))
    return out


def gaussian_kernels(sigmas=(0.5, 1.0, 1.5, 2.0, 3.0)) -> list:
    out = []
    for sig in sigmas:
        s = min(PAD, int(2 * np.ceil(3 * sig) + 1))
        ax = np.arange(s) - (s - 1) / 2
        xx, yy = np.meshgrid(ax, ax)
        k = np.exp(-(xx ** 2 + yy ** 2) / (2 * sig ** 2)).astype(np.float32)
        out.append(_padded(k))
    return out


def line_kernels(sizes=(3, 5, 7, 9), angles_per_size=None) -> list:
    """LinearMotionBlur line kernels at the pyblur-quantized angles
    (pyblur LineDictionary: 4/6/8/10 directions for sizes 3/5/7/9)."""
    if angles_per_size is None:
        angles_per_size = {3: 4, 5: 6, 7: 8, 9: 10}
    out = []
    for s in sizes:
        num = angles_per_size.get(s, 8)
        for i in range(num):
            theta = np.pi * i / num
            k = np.zeros((s, s), np.float32)
            c = (s - 1) / 2
            # rasterize the line through the center
            ts = np.linspace(-c, c, 4 * s)
            xs = np.clip(np.round(c + ts * np.cos(theta)), 0, s - 1)
            ys = np.clip(np.round(c - ts * np.sin(theta)), 0, s - 1)
            k[ys.astype(int), xs.astype(int)] = 1.0
            out.append(_padded(k))
    return out


def measured_psf_kernels(path: str = MEASURED_PSF_PATH) -> list:
    """The 100 measured camera-shake PSFs (pyblur PsfBlur.py:9-25 psf.pkl),
    centered on the (PAD, PAD) canvas, unit mass."""
    bank = np.load(path)["psfs"].astype(np.float32)
    return [k / k.sum() for k in bank]


def psf_kernels(num: int = 100, seed: int = 0, size: int = PAD) -> list:
    """Procedural camera-shake PSFs: smoothed random-walk trajectories
    (fallback when the measured assets/psf_bank.npz is unavailable)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        steps = rng.integers(8, 40)
        pos = np.zeros(2)
        vel = rng.normal(0, 1, 2)
        traj = [pos.copy()]
        for _ in range(steps):
            vel = 0.9 * vel + rng.normal(0, 0.35, 2)
            pos = pos + vel
            traj.append(pos.copy())
        traj = np.asarray(traj)
        traj -= traj.mean(axis=0)
        span = max(np.abs(traj).max(), 1e-6)
        scale = (size // 2 - 2) * rng.uniform(0.2, 1.0) / span
        traj = traj * scale + size // 2
        k = np.zeros((size, size), np.float32)
        for p in traj:
            x, y = int(round(p[0])), int(round(p[1]))
            if 0 <= x < size and 0 <= y < size:
                k[y, x] += 1.0
        # slight gaussian smoothing like a real PSF
        from scipy.ndimage import gaussian_filter
        k = gaussian_filter(k, rng.uniform(0.3, 0.8))
        if k.sum() <= 0:
            k[size // 2, size // 2] = 1.0
        out.append((k / k.sum()).astype(np.float32))
    return out


def build_pyblur_bank(include_psf: bool = True, seed: int = 0) -> np.ndarray:
    """Full (K, 21, 21) bank: box + disk + gaussian + line (+100 PSFs —
    measured when assets/psf_bank.npz is present, procedural otherwise)."""
    kernels = (box_kernels() + disk_kernels() + gaussian_kernels() +
               line_kernels())
    if include_psf:
        if osp.exists(MEASURED_PSF_PATH):
            kernels += measured_psf_kernels()
        else:
            kernels += psf_kernels(seed=seed)
    return np.stack(kernels).astype(np.float32)
