"""Host-side datasets: file IO, decode and resize only.

Port of `image_restoration_tpu/data/datasets.py:33-128`: the degradation
synthesis runs on the device (data/pipelines.py), so a dataset returns GT
images and exposes `device_pipeline()`, the degradation for the step.
Only the disk backend and `FFHQDegradationDataset` without
`crop_components` are ported.
"""

from __future__ import annotations

from os import path as osp

import numpy as np

from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .pipelines import FFHQDegradationConfig, make_ffhq_degradation


def _gather_paths(root: str, backend_opt: dict):
    """Sorted image paths under `root` (disk backend)."""
    backend = backend_opt.get("type", "disk")
    if backend != "disk":
        raise NotImplementedError(
            f"io_backend {backend!r} is not ported yet (ROADMAP item 20); "
            "only 'disk' is")
    return sorted(osp.join(root, p) for p in scandir(
        root, suffix=("png", "jpg", "jpeg", "bmp", "webp"), recursive=True))


class _BaseDataset:
    def __init__(self, opt: dict):
        self.opt = opt

    def __len__(self):
        return len(self.paths)

    def device_pipeline(self):
        return None


def _read_bgr_float(path: str) -> np.ndarray:
    import cv2
    img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / 255.0


@DATASET_REGISTRY.register()
class FFHQDegradationDataset(_BaseDataset):
    """GT-only dataset; the production degradation chain runs on the
    device."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        if opt.get("crop_components", False):
            raise NotImplementedError(
                "crop_components (the component discriminators' char boxes) "
                "is not ported yet (ROADMAP item 16)")
        self.io_backend_opt = opt.get("io_backend", {"type": "disk"})
        self.paths = _gather_paths(opt["dataroot_gt"], self.io_backend_opt)
        self.input_width = opt.get("input_width", 256)
        self.input_height = opt.get("input_height", 256)
        self.mean = opt.get("mean", (0.5, 0.5, 0.5))
        self.std = opt.get("std", (0.5, 0.5, 0.5))

    def __getitem__(self, index: int):
        import cv2
        path = self.paths[index]
        img = _read_bgr_float(path)
        img = cv2.resize(img, (self.input_width, self.input_height),
                         interpolation=cv2.INTER_LINEAR)
        return {"gt": img[..., ::-1].copy(), "gt_path": path}  # RGB [0,1]

    def device_pipeline(self):
        opt = self.opt
        cfg = FFHQDegradationConfig(
            blur_kernel_size=opt.get("blur_kernel_size", 21),
            min_kernel_size=opt.get("min_kernel_size",
                                    opt.get("blur_kernel_size", 21)),
            kernel_list=tuple(opt.get("kernel_list",
                                      FFHQDegradationConfig.kernel_list)),
            kernel_prob=tuple(opt.get("kernel_prob",
                                      FFHQDegradationConfig.kernel_prob)),
            blur_sigma=tuple(opt.get("blur_sigma", (0.1, 10))),
            downsample_range=tuple(opt.get("downsample_range", (4.0, 12.0))),
            noise_range=tuple(opt["noise_range"])
            if opt.get("noise_range") else None,
            jpeg_range=tuple(opt["jpeg_range"])
            if opt.get("jpeg_range") else None,
            color_jitter_prob=opt.get("color_jitter_prob"),
            color_jitter_shift=opt.get("color_jitter_shift", 20) / 255.0,
            color_jitter_pt_prob=opt.get("color_jitter_pt_prob"),
            gray_prob=opt.get("gray_prob", 0.0),
            gt_gray=bool(opt.get("gt_gray", False)),
            use_hflip=opt.get("use_hflip", False),
            mean=tuple(self.mean), std=tuple(self.std))
        return make_ffhq_degradation(cfg)
