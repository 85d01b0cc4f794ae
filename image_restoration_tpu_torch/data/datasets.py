"""Host-side datasets: file IO, decode and resize only.

Port of `image_restoration_tpu/data/datasets.py`: the degradation
synthesis runs on the device (data/pipelines.py), so a GT-only dataset
returns GT images and exposes `device_pipeline()`, the degradation for the
step. Ported: `FFHQDegradationDataset` (with `crop_components`: each item
gains the (10, 4) `char_boxes` of its image), `OCRDegradationDataset` (the
padded plates and the masks), `FFHQDataset` (GT only, for
StyleGAN2Model), `RealESRGANDataset` (with its `RealSRDegradationDataset`
alias), `PairedImageDataset` and `SingleImageDataset`. The GT-only and
LQ-only datasets read through `utils/file_client.py`'s backends (disk,
lmdb, pak, memcached); `PairedImageDataset` reads from disk, as JAX's does.
The random crops draw from numpy's global generator and the flips from
Python's `random`, as in the JAX package, so one seed gives the same
samples.
"""

from __future__ import annotations

from os import path as osp

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .masks import build_irregular_mask_bank
from .pipelines import (FFHQDegradationConfig, OCRDegradation,
                        RealESRGANDegradationConfig, make_ffhq_degradation,
                        make_realesrgan_degradation)
from .transforms import augment, paired_random_crop


def _gather_paths(root: str, backend_opt: dict):
    """(paths, client) of the images under `root` (JAX :34-43): for lmdb
    and pak the sorted keys of the store at `root` (an lmdb's keys are the
    image stems), else the sorted image files under the folder, read
    through `client`."""
    opt = dict(backend_opt)
    backend = opt.pop("type", "disk")
    if backend == "lmdb":
        client = FileClient("lmdb", db_paths=root)
        return sorted(client.keys()), client
    if backend == "pak":
        client = FileClient("pak", pak_path=root)
        return sorted(client.keys()), client
    client = FileClient(backend, **opt)
    paths = sorted(osp.join(root, p) for p in scandir(
        root, suffix=("png", "jpg", "jpeg", "bmp", "webp"), recursive=True))
    return paths, client


class _BaseDataset:
    def __init__(self, opt: dict):
        self.opt = opt

    def __len__(self):
        return len(self.paths)

    def device_pipeline(self):
        return None

    def _read(self, path: str) -> np.ndarray:
        """HWC BGR float32 in [0, 1], read through the dataset's client."""
        return imfrombytes(self.client.get(path), float32=True)


@DATASET_REGISTRY.register()
class FFHQDegradationDataset(_BaseDataset):
    """GT-only dataset; the production degradation chain runs on the
    device."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.io_backend_opt = opt.get("io_backend", {"type": "disk"})
        self.paths, self.client = _gather_paths(opt["dataroot_gt"],
                                                self.io_backend_opt)
        self.input_width = opt.get("input_width", 256)
        self.input_height = opt.get("input_height", 256)
        self.mean = opt.get("mean", (0.5, 0.5, 0.5))
        self.std = opt.get("std", (0.5, 0.5, 0.5))
        # the char boxes of the component discriminators (JAX :68-84): an
        # .npz with an (N, 10, 4) `boxes` array, or the reference's .pth
        # dict keyed '%08d' with `char_0`..`char_9` 4-vectors
        self.crop_components = opt.get("crop_components", False)
        if self.crop_components:
            if opt.get("use_hflip", False):
                # the flip runs on the device after the boxes are read, and
                # JAX leaves the boxes unflipped (ROADMAP Queue 3)
                raise ValueError(
                    "crop_components with use_hflip: the char boxes would "
                    "not follow the flipped image; set use_hflip: false")
            path = opt["component_path"]
            if path.endswith(".npz"):
                with np.load(path) as f:
                    self.components_list = np.asarray(f["boxes"], np.float32)
            else:
                import torch
                self.components_list = torch.load(path, map_location="cpu",
                                                  weights_only=False)

    def _component_boxes(self, index: int) -> np.ndarray:
        """(10, 4) float32 [x1, y1, x2, y2] char boxes of image `index`."""
        if not isinstance(self.components_list, dict):
            return np.asarray(self.components_list[index], np.float32)
        entry = self.components_list[f"{index:08d}"]
        return np.stack([np.asarray(entry[f"char_{i}"][0:4], np.float32)
                         for i in range(10)])

    def __getitem__(self, index: int):
        import cv2
        path = self.paths[index]
        img = self._read(path)
        img = cv2.resize(img, (self.input_width, self.input_height),
                         interpolation=cv2.INTER_LINEAR)
        item = {"gt": img[..., ::-1].copy(), "gt_path": path}  # RGB [0,1]
        if self.crop_components:
            item["char_boxes"] = self._component_boxes(index)
        return item

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


@DATASET_REGISTRY.register()
class OCRDegradationDataset(FFHQDegradationDataset):
    """FFHQ's pipeline, an aspect-preserving pad and random occlusion masks
    (JAX :172-223; the reference's `pad_input` :214-223, mask suite
    :92-183). With `pad_input` (the default) an image is resized (cv2
    bilinear) to fit input_width × input_height and centred on a white
    canvas, else resized to it. With `random_mask`, `device_pipeline()`
    chains the FFHQ degradation with `masks.apply_random_mask` under
    `mask_prob`, filled white in normalized space (also for a non-square
    plate, where JAX's square bank fails: ROADMAP Queue 3)."""

    def __getitem__(self, index: int):
        import cv2
        path = self.paths[index]
        img = self._read(path)
        if self.opt.get("pad_input", True):
            h, w = img.shape[:2]
            scale = min(self.input_width / w, self.input_height / h)
            nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
            resized = cv2.resize(img, (nw, nh),
                                 interpolation=cv2.INTER_LINEAR)
            img = np.ones((self.input_height, self.input_width, 3),
                          np.float32)
            y0 = (self.input_height - nh) // 2
            x0 = (self.input_width - nw) // 2
            img[y0:y0 + nh, x0:x0 + nw] = resized
        else:
            img = cv2.resize(img, (self.input_width, self.input_height),
                             interpolation=cv2.INTER_LINEAR)
        return {"gt": img[..., ::-1].copy(), "gt_path": path}

    def device_pipeline(self):
        base = super().device_pipeline()
        if not self.opt.get("random_mask", False):
            return base
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        white = float(((1.0 - mean) / std)[0])  # fill in normalized space
        # JAX's bank is input_height² and its masks fail to broadcast over
        # a non-square plate; the port draws a max(H, W)² bank and crops
        # it (the same bank as JAX's for a square input)
        h, w = self.input_height, self.input_width
        bank = build_irregular_mask_bank(max(h, w))[:, :h, :w]
        return OCRDegradation(base, bank, self.opt.get("mask_prob", 0.5),
                              white)


@DATASET_REGISTRY.register()
class FFHQDataset(_BaseDataset):
    """GT only, for StyleGAN2 pretraining (JAX :302-321): a random
    horizontal flip, BGR → RGB and (x − mean)/std; no degradation."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.io_backend_opt = opt.get("io_backend", {"type": "disk"})
        self.paths, self.client = _gather_paths(opt["dataroot_gt"],
                                                self.io_backend_opt)
        self.mean = np.asarray(opt.get("mean", (0.5, 0.5, 0.5)), np.float32)
        self.std = np.asarray(opt.get("std", (0.5, 0.5, 0.5)), np.float32)

    def __getitem__(self, index: int):
        path = self.paths[index]
        img = augment(self._read(path),
                      hflip=self.opt.get("use_hflip", True), rotation=False)
        img = img[..., ::-1]
        return {"gt": ((img - self.mean) / self.std).astype(np.float32),
                "gt_path": path}


@DATASET_REGISTRY.register()
class RealESRGANDataset(_BaseDataset):
    """GT-only: a random gt_size² crop (GT smaller than that is resized up
    first) and flips; the second-order Real-ESRGAN chain runs on the
    device."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.io_backend_opt = opt.get("io_backend", {"type": "disk"})
        self.paths, self.client = _gather_paths(opt["dataroot_gt"],
                                                self.io_backend_opt)
        self.gt_size = opt.get("gt_size", 256)
        self.use_hflip = opt.get("use_hflip", True)
        self.use_rot = opt.get("use_rot", False)

    def __getitem__(self, index: int):
        import cv2
        path = self.paths[index]
        img = self._read(path)
        h, w = img.shape[:2]
        if h < self.gt_size or w < self.gt_size:
            img = cv2.resize(img, (max(w, self.gt_size),
                                   max(h, self.gt_size)))
            h, w = img.shape[:2]
        top = np.random.randint(0, h - self.gt_size + 1)
        left = np.random.randint(0, w - self.gt_size + 1)
        img = img[top:top + self.gt_size, left:left + self.gt_size]
        img = augment(img, self.use_hflip, self.use_rot)
        return {"gt": img[..., ::-1].copy(), "gt_path": path}

    def device_pipeline(self):
        """The chain of the `RealESRGANDegradationConfig` fields the options
        set (lists as tuples), the dataclass's defaults for the rest."""
        kwargs = {}
        for f in RealESRGANDegradationConfig.__dataclass_fields__:
            if f in self.opt:
                v = self.opt[f]
                kwargs[f] = tuple(v) if isinstance(v, list) else v
        return make_realesrgan_degradation(
            RealESRGANDegradationConfig(**kwargs))


RealSRDegradationDataset = DATASET_REGISTRY.register(
    type("RealSRDegradationDataset", (RealESRGANDataset,), {}))


def _normalized(img: np.ndarray, mean, std) -> np.ndarray:
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@DATASET_REGISTRY.register()
class PairedImageDataset(_BaseDataset):
    """LQ/GT pairs: the GT folder's images (or the names of a
    `meta_info_file`), each with the LQ of the name `filename_tmpl` makes
    from its stem, read from disk. In the train phase a paired random crop of gt_size and
    flips; RGB [0, 1], normalized when `mean` is set."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.mean = opt.get("mean")
        self.std = opt.get("std")
        gt_folder, lq_folder = opt["dataroot_gt"], opt["dataroot_lq"]
        tmpl = opt.get("filename_tmpl", "{}")

        def lq_name(name):
            stem, ext = osp.splitext(name)
            return tmpl.format(stem) + ext

        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"]) as f:
                names = [line.strip().split(" ")[0] for line in f]
        else:
            names = sorted(scandir(gt_folder,
                                   suffix=("png", "jpg", "jpeg", "bmp")))
        self.paths = [(osp.join(lq_folder, lq_name(n)),
                       osp.join(gt_folder, n)) for n in names]
        self.client = FileClient("disk")

    def __getitem__(self, index: int):
        lq_path, gt_path = self.paths[index]
        img_lq = self._read(lq_path)
        img_gt = self._read(gt_path)
        if self.opt.get("phase") == "train":
            scale = self.opt.get("scale", 1)
            img_gt, img_lq = paired_random_crop(img_gt, img_lq,
                                                self.opt["gt_size"], scale,
                                                gt_path)
            img_gt, img_lq = augment([img_gt, img_lq],
                                     self.opt.get("use_hflip", True),
                                     self.opt.get("use_rot", True))
        out = {"lq": img_lq[..., ::-1].copy(),
               "gt": img_gt[..., ::-1].copy(),
               "lq_path": lq_path, "gt_path": gt_path}
        if self.mean is not None:
            out["lq"] = _normalized(out["lq"], self.mean, self.std)
            out["gt"] = _normalized(out["gt"], self.mean, self.std)
        return out


@DATASET_REGISTRY.register()
class SingleImageDataset(_BaseDataset):
    """LQ only (a test set without GT); RGB [0, 1], normalized when `mean`
    is set."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.io_backend_opt = opt.get("io_backend", {"type": "disk"})
        self.paths, self.client = _gather_paths(opt["dataroot_lq"],
                                                self.io_backend_opt)
        self.mean = opt.get("mean")
        self.std = opt.get("std")

    def __getitem__(self, index: int):
        path = self.paths[index]
        img = self._read(path)[..., ::-1].copy()
        if self.mean is not None:
            img = _normalized(img, self.mean, self.std)
        return {"lq": img, "lq_path": path}
