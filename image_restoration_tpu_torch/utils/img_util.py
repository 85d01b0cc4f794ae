"""Image ↔ array conversion utilities.

Port of `image_restoration_tpu/utils/img_util.py` (img2tensor,
tensor2img, imfrombytes, imread, imwrite, crop_border). Arrays are
channel-last numpy; BGR↔RGB conventions match the reference (cv2 IO is
BGR). `tensor2img` also takes a torch tensor, which it copies to the host.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def img2tensor(imgs, bgr2rgb: bool = True, float32: bool = True):
    """HWC BGR uint8/float32 [0,1] numpy → HWC RGB float array (NHWC-ready)."""
    def _one(img):
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] == 3 and bgr2rgb:
            if img.dtype == np.float64:
                img = img.astype(np.float32)
            img = img[..., ::-1].copy()
        return img.astype(np.float32) if float32 else img

    if isinstance(imgs, (list, tuple)):
        return [_one(i) for i in imgs]
    return _one(imgs)


def _to_numpy(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):  # torch.Tensor
        tensor = tensor.detach().float().cpu().numpy()
    return np.asarray(tensor, dtype=np.float32)


def tensor2img(tensor, rgb2bgr: bool = True, out_type=np.uint8,
               min_max=(0, 1)):
    """NHWC/HWC float array → HWC BGR uint8 image.

    Clamps to min_max, renormalizes to [0,1], rounds to uint8.
    """
    arr = _to_numpy(tensor)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            return [tensor2img(a, rgb2bgr, out_type, min_max) for a in arr]
        arr = arr[0]
    arr = np.clip(arr, min_max[0], min_max[1])
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if arr.shape[-1] == 3 and rgb2bgr:
        arr = arr[..., ::-1]
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    if out_type == np.uint8:
        arr = (arr * 255.0).round().astype(np.uint8)
    else:
        arr = arr.astype(out_type)
    return arr


def imfrombytes(content: bytes, flag: str = "color",
                float32: bool = False) -> np.ndarray:
    """Decode image bytes → HWC BGR (float32 in [0, 1] with `float32`)."""
    imread_flags = {"color": cv2.IMREAD_COLOR, "grayscale":
                    cv2.IMREAD_GRAYSCALE, "unchanged": cv2.IMREAD_UNCHANGED}
    img = cv2.imdecode(np.frombuffer(content, np.uint8), imread_flags[flag])
    if img is None:
        raise ValueError("image bytes could not be decoded")
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imread(path: str, float32: bool = True, bgr2rgb: bool = True) -> np.ndarray:
    """Read an image file → HWC float32 (RGB by default)."""
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    if bgr2rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imwrite(img: np.ndarray, file_path: str, params=None,
            auto_mkdir: bool = True) -> bool:
    """Write HWC BGR uint8."""
    if auto_mkdir:
        dir_name = os.path.abspath(os.path.dirname(file_path))
        os.makedirs(dir_name, exist_ok=True)
    ok = cv2.imwrite(file_path, img, params or [])
    if not ok:
        raise IOError(f"Failed writing {file_path}")
    return ok


def crop_border(imgs, crop_border: int):
    """Crop `crop_border` pixels off each side of HWC / NHWC images, or of
    each image of a list (JAX `utils/img_util.py:101-113`)."""
    if crop_border == 0:
        return imgs

    def _one(img):
        if img.ndim == 4:
            return img[:, crop_border:-crop_border,
                       crop_border:-crop_border, :]
        return img[crop_border:-crop_border, crop_border:-crop_border, ...]

    if isinstance(imgs, (list, tuple)):
        return [_one(i) for i in imgs]
    return _one(imgs)
