"""Detector dataset and augmentation, on the host.

Port of `image_restoration_tpu/detect/dataset.py:24-172` (parity with
Plate_Detect/Retina-License-Plate/data/{license_plate.py:9-90,
data_augment.py}): `label.txt` parsing (bbox and 5×(x, y, conf)
landmarks, label −1 when the landmarks are invalid), random crop,
photometric distortion, pad to square, mirror, resize and mean
subtraction. numpy, cv2 and Python's `random`, as in JAX: under one
`random.seed` both give the same arrays.

Targets come out as a fixed (M, 15) padded array in normalized
coordinates, for `multibox_loss`.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

BGR_MEAN = (104.0, 117.0, 123.0)


def parse_label_file(txt_path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Parse the widerface-style label.txt (ref license_plate.py:10-35)."""
    imgs, words = [], []
    labels: List[List[float]] = []
    first = True
    with open(txt_path) as f:
        for line in f:
            line = line.rstrip()
            if line.startswith("#"):
                if not first:
                    words.append(labels.copy())
                    labels.clear()
                first = False
                imgs.append(txt_path.replace("label.txt", "images/")
                            + line[2:])
            elif line:
                labels.append([float(x) for x in line.split(" ")])
    words.append(labels)
    return imgs, words


def annotations_from_labels(labels) -> np.ndarray:
    """→ (M, 15): x1,y1,x2,y2, 5×(x,y), landmark-validity label.

    Ref license_plate.py:46-74 (landmark conf columns skipped).
    """
    if len(labels) == 0:
        return np.zeros((0, 15), np.float32)
    out = np.zeros((len(labels), 15), np.float32)
    for i, lab in enumerate(labels):
        out[i, 0] = lab[0]
        out[i, 1] = lab[1]
        out[i, 2] = lab[0] + lab[2]
        out[i, 3] = lab[1] + lab[3]
        lm = [lab[4], lab[5], lab[7], lab[8], lab[10], lab[11], lab[13],
              lab[14], lab[16], lab[17]] if len(lab) >= 18 else [-1.0] * 10
        out[i, 4:14] = lm
        out[i, 14] = -1.0 if out[i, 4] < 0 else 1.0
    return out


def _distort(img: np.ndarray) -> np.ndarray:
    """Photometric distortion (ref data_augment.py _distort)."""
    img = img.copy()
    if random.random() < 0.5:
        img += random.uniform(-32, 32)
    if random.random() < 0.5:
        img *= random.uniform(0.5, 1.5)
    if random.random() < 0.5:
        # saturation/hue in a cheap RGB approximation
        gray = img.mean(axis=2, keepdims=True)
        img = gray + (img - gray) * random.uniform(0.5, 1.5)
    return np.clip(img, 0, 255)


def _crop(img, boxes, labels, landms):
    """Random ROI crop keeping box centers (simplified _crop from
    data_augment.py)."""
    h, w = img.shape[:2]
    for _ in range(20):
        scale = random.uniform(0.3, 1.0)
        sw, sh = int(w * scale), int(h * scale)
        left = random.randint(0, w - sw)
        top = random.randint(0, h - sh)
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        mask = ((centers[:, 0] > left) & (centers[:, 0] < left + sw) &
                (centers[:, 1] > top) & (centers[:, 1] < top + sh))
        if not mask.any():
            continue
        img2 = img[top:top + sh, left:left + sw]
        boxes2 = boxes[mask].copy()
        landms2 = landms[mask].copy()
        labels2 = labels[mask].copy()
        boxes2[:, 0::2] = np.clip(boxes2[:, 0::2] - left, 0, sw)
        boxes2[:, 1::2] = np.clip(boxes2[:, 1::2] - top, 0, sh)
        landms2[:, 0::2] -= left
        landms2[:, 1::2] -= top
        return img2, boxes2, labels2, landms2
    return img, boxes, labels, landms


def preproc(img_bgr: np.ndarray, annotations: np.ndarray,
            image_size: int = 224, max_objects: int = 32,
            train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Augment + resize + mean-subtract; pad targets to (max_objects, 15)
    with coordinates normalized to [0,1]."""
    img = img_bgr.astype(np.float32)
    boxes = annotations[:, :4].copy()
    landms = annotations[:, 4:14].copy()
    labels = annotations[:, 14].copy()

    if train and len(boxes):
        img, boxes, labels, landms = _crop(img, boxes, labels, landms)
        img = _distort(img)
        # pad to square
        h, w = img.shape[:2]
        size = max(h, w)
        canvas = np.full((size, size, 3), BGR_MEAN, np.float32)
        canvas[:h, :w] = img
        img = canvas
        # mirror
        if random.random() < 0.5:
            img = img[:, ::-1]
            sz = img.shape[1]
            boxes = boxes.copy()
            boxes[:, 0::2] = sz - boxes[:, 2::-2]
            landms = landms.copy()
            landms[:, 0::2] = sz - landms[:, 0::2]
            # reorder corner landmarks left/right (1↔2, 3↔4)
            order = [2, 3, 0, 1, 6, 7, 4, 5, 8, 9]
            landms = landms[:, order]

    h, w = img.shape[:2]
    import cv2
    img = cv2.resize(img, (image_size, image_size),
                     interpolation=cv2.INTER_LINEAR)
    img -= np.asarray(BGR_MEAN, np.float32)

    target = np.zeros((max_objects, 15), np.float32)
    n = min(len(boxes), max_objects)
    if n:
        target[:n, 0:4:2] = boxes[:n, 0::2] / w
        target[:n, 1:4:2] = boxes[:n, 1::2] / h
        target[:n, 4:14:2] = landms[:n, 0::2] / w
        target[:n, 5:14:2] = landms[:n, 1::2] / h
        target[:n, 14] = labels[:n]
    return img, target


class LicensePlateDetection:
    """Map-style dataset over a label.txt tree."""

    def __init__(self, txt_path: str, image_size: int = 224,
                 max_objects: int = 32, train: bool = True):
        self.imgs_path, self.words = parse_label_file(txt_path)
        self.image_size = image_size
        self.max_objects = max_objects
        self.train = train

    def __len__(self):
        return len(self.imgs_path)

    def __getitem__(self, index: int):
        import cv2
        img = cv2.imread(self.imgs_path[index])
        ann = annotations_from_labels(self.words[index])
        img, target = preproc(img, ann, self.image_size, self.max_objects,
                              self.train)
        return {"image": img, "target": target}
