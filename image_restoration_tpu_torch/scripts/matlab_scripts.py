"""The MATLAB data and post-processing scripts: bicubic test and training
sets, back-projection and reverse filtering.

Port of `scripts/matlab_scripts.py:28-147` (after BasicSR's
`generate_bicubic_img.m`, `backprojection.m`/`main_bp.m` and
`main_reverse_filter.m`) on the port's MATLAB-exact `ops.resize.imresize`,
on the device (`--device`, default cuda; `--device cpu` runs the same on
the CPU). JAX's `lax.scan` of back-projection is a loop of device ops.

    python -m image_restoration_tpu_torch.scripts.matlab_scripts \\
        generate_bicubic --input_folder DIV2K_train_HR \\
        --save_mod_folder GTmod12 --save_lr_folder LRbicx4 \\
        [--save_bic_folder Bicx4] --mod_scale 12 --up_scale 4
    python -m image_restoration_tpu_torch.scripts.matlab_scripts bp \\
        --lr_folder LR/ --preout_folder SR/ --save_folder BP/
    python -m image_restoration_tpu_torch.scripts.matlab_scripts \\
        reverse_filter --lr_folder LR/ --preout_folder SR/ --save_folder RF/

(`--device cpu` goes before the subcommand; `backprojection` names `bp`
too.)

Images are written as MATLAB's `imwrite` writes a double image: ×255,
rounded to the nearest level (JAX's script truncates instead, which puts
its bicubic sets half a level below MATLAB's on average).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import imresize
from ..utils.device import resolve_device
from ..utils.misc import scandir


def to_uint8(img) -> np.ndarray:
    """A float image in [0, 1] (array or tensor) → uint8, rounded to the
    nearest level, as MATLAB's im2uint8."""
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    return np.clip(np.round(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


def _gauss_p() -> np.ndarray:
    """fspecial('gaussian', 5, 1), squared and renormalized
    (backprojection.m)."""
    ax = np.arange(5) - 2.0
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 2.0)
    g /= g.sum()
    p = g ** 2
    return (p / p.sum()).astype(np.float32)


def backprojection(im_h: torch.Tensor, im_l: torch.Tensor,
                   max_iter: int = 20) -> torch.Tensor:
    """Iterative back-projection of an HWC float image `im_h` against its
    LR `im_l`: `max_iter` times, the bicubic re-downsampling residual is
    upsampled, blurred by the squared Gaussian (zero padding) and added."""
    c = im_h.shape[-1]
    p = torch.as_tensor(_gauss_p(), device=im_h.device)
    p = p.expand(c, 1, 5, 5)
    scale_dn = im_l.shape[0] / im_h.shape[0]
    scale_up = im_h.shape[0] / im_l.shape[0]
    im = im_h.float()
    im_l = im_l.float()
    for _ in range(max_iter):
        im_l_s = imresize(im, scale_dn)
        diff = imresize(im_l - im_l_s, scale_up)
        blurred = F.conv2d(diff.permute(2, 0, 1)[None], p, padding=2,
                           groups=c)[0].permute(1, 2, 0)
        im = im + blurred
    return im


def reverse_filter(im_out: torch.Tensor, im_l: torch.Tensor, scale: int = 4,
                   max_iter: int = 20) -> torch.Tensor:
    """Iterative reverse filtering: `max_iter` times, add the bicubic-up LR
    minus the image's bicubic down-up round trip."""
    j = imresize(im_l.float(), scale)
    im = im_out.float()
    for _ in range(max_iter):
        im = im + (j - imresize(imresize(im, 1.0 / scale), scale))
    return im


def _read(path: str, device) -> torch.Tensor:
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return torch.from_numpy(img.astype(np.float32) / 255.0).to(device)


def run_folder(mode: str, lr_folder: str, preout_folder: str,
               save_folder: str, max_iter: int = 20, scale: int = 4,
               device=None) -> int:
    """Back-project ("bp") or reverse-filter every PNG of `preout_folder`
    against the same-named LR image; returns the count written."""
    dev = resolve_device(device)
    os.makedirs(save_folder, exist_ok=True)
    names = sorted(scandir(preout_folder, suffix=("png",)))
    for name in names:
        im_l = _read(osp.join(lr_folder, name), dev)
        im_h = _read(osp.join(preout_folder, name), dev)
        out = backprojection(im_h, im_l, max_iter) if mode == "bp" \
            else reverse_filter(im_h, im_l, scale, max_iter)
        cv2.imwrite(osp.join(save_folder, name), to_uint8(out))
        print(name)
    return len(names)


def generate_bicubic(input_folder: str, save_mod: str | None,
                     save_lr: str | None, save_bic: str | None,
                     mod_scale: int = 12, up_scale: int = 2,
                     device=None) -> int:
    """generate_bicubic_img.m: each image mod-cropped to a multiple of
    `mod_scale` (saved to `save_mod`), its MATLAB-bicubic LR at 1/up_scale
    (to `save_lr`), and that LR bicubic-upsampled back (to `save_bic`); a
    folder left None is not written. Names keep the stem, as `.png`.
    Returns the count of images."""
    dev = resolve_device(device)
    for d in (save_mod, save_lr, save_bic):
        if d:
            os.makedirs(d, exist_ok=True)
    names = sorted(scandir(input_folder,
                           suffix=("png", "jpg", "jpeg", "bmp")))
    for name in names:
        img = _read(osp.join(input_folder, name), dev)
        h, w = img.shape[:2]
        img = img[:h - h % mod_scale, :w - w % mod_scale]
        base = osp.splitext(name)[0] + ".png"
        if save_mod:
            cv2.imwrite(osp.join(save_mod, base), to_uint8(img))
        lr = imresize(img, 1.0 / up_scale)
        if save_lr:
            cv2.imwrite(osp.join(save_lr, base), to_uint8(lr))
        if save_bic:
            cv2.imwrite(osp.join(save_bic, base),
                        to_uint8(imresize(lr, float(up_scale))))
        print(base)
    return len(names)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for mode, aliases in (("bp", ["backprojection"]), ("reverse_filter", [])):
        sp = sub.add_parser(mode, aliases=aliases)
        sp.add_argument("--lr_folder", required=True)
        sp.add_argument("--preout_folder", required=True)
        sp.add_argument("--save_folder", required=True)
        sp.add_argument("--max_iter", type=int, default=20)
        sp.add_argument("--scale", type=int, default=4)
    sp = sub.add_parser("generate_bicubic")
    sp.add_argument("--input_folder", required=True)
    sp.add_argument("--save_mod_folder", default=None)
    sp.add_argument("--save_lr_folder", default=None)
    sp.add_argument("--save_bic_folder", default=None)
    sp.add_argument("--mod_scale", type=int, default=12)
    sp.add_argument("--up_scale", type=int, default=2)
    args = p.parse_args(argv)
    if args.cmd == "generate_bicubic":
        return generate_bicubic(args.input_folder, args.save_mod_folder,
                                args.save_lr_folder, args.save_bic_folder,
                                args.mod_scale, args.up_scale, args.device)
    mode = "bp" if args.cmd in ("bp", "backprojection") else args.cmd
    return run_folder(mode, args.lr_folder, args.preout_folder,
                      args.save_folder, args.max_iter, args.scale,
                      args.device)


if __name__ == "__main__":
    main()
