"""Host-side image transforms.

Port of `image_restoration_tpu/data/transforms.py` (whole): `mod_crop`,
`paired_random_crop`, `augment` (with optical flows) and `img_rotate`, on
numpy HWC arrays. The crops and flips draw from Python's `random`, as the
JAX package's do, so one seed crops and flips the same in both.
"""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop height and width down to multiples of `scale`."""
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    h, w = img.shape[0], img.shape[1]
    return img[:h - h % scale, :w - w % scale, ...]


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int,
                       gt_path: str = ""):
    """The same random window of each GT (gt_patch_size²) and each LQ
    (gt_patch_size/scale)²; lists in, lists out (a single image unwrapped)."""
    if not isinstance(img_gts, list):
        img_gts = [img_gts]
    if not isinstance(img_lqs, list):
        img_lqs = [img_lqs]

    h_lq, w_lq = img_lqs[0].shape[0:2]
    h_gt, w_gt = img_gts[0].shape[0:2]
    lq_patch_size = gt_patch_size // scale

    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"Scale mismatches. GT ({h_gt}, {w_gt}) is not "
                         f"{scale}x of LQ ({h_lq}, {w_lq}). Path: {gt_path}")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq}, {w_lq}) smaller than patch size "
                         f"({lq_patch_size}, {lq_patch_size}). "
                         f"Path: {gt_path}")

    top = random.randint(0, h_lq - lq_patch_size)
    left = random.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt:top_gt + gt_patch_size,
                 left_gt:left_gt + gt_patch_size, ...] for v in img_gts]
    if len(img_gts) == 1:
        img_gts = img_gts[0]
    if len(img_lqs) == 1:
        img_lqs = img_lqs[0]
    return img_gts, img_lqs


def augment(imgs, hflip: bool = True, rotation: bool = True, flows=None,
            return_status: bool = False):
    """Horizontal flip, vertical flip and transpose, each with probability
    one half, the same for every image (and flow) of the call."""
    hflip = hflip and random.random() < 0.5
    vflip = rotation and random.random() < 0.5
    rot90 = rotation and random.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...].copy()
        if vflip:
            img = img[::-1, :, ...].copy()
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return img

    def _augment_flow(flow):
        if hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return flow

    if not isinstance(imgs, list):
        imgs = [imgs]
    imgs = [_augment(img) for img in imgs]
    if len(imgs) == 1:
        imgs = imgs[0]

    if flows is not None:
        if not isinstance(flows, list):
            flows = [flows]
        flows = [_augment_flow(f) for f in flows]
        if len(flows) == 1:
            flows = flows[0]
        return imgs, flows
    if return_status:
        return imgs, (hflip, vflip, rot90)
    return imgs


def img_rotate(img: np.ndarray, angle: float, center=None,
               scale: float = 1.0) -> np.ndarray:
    """Rotate by `angle` degrees about `center` (the image centre) with
    cv2."""
    import cv2
    h, w = img.shape[:2]
    if center is None:
        center = (w // 2, h // 2)
    matrix = cv2.getRotationMatrix2D(center, angle, scale)
    return cv2.warpAffine(img, matrix, (w, h))
