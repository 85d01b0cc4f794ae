"""Single-image / batch restoration inference on the GPU.

Port of `image_restoration_tpu/infer.py:27-273`: `PRODUCTION_GFPGAN`, the
`Restorer` over every registered arch whose forward takes one NHWC image
and returns an image (`IMAGE_ARCHS`; float path `restore_batch`/`__call__`,
device-IO path `restore_batch_u8`, halo-tiled `restore_tiled`/
`restore_tiled_u8`), the dynamic-int8 serving mode (`quant="dyn-int8"`),
`data_parallel=N` (one replica of the net per device, the batch or the
tile chunks split over them in order) and the `--arch
gfpgan_ocr|rrdbnet|srvgg [--tile N] [--bf16]` CLI.
"""

from __future__ import annotations

import argparse
import copy
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .archs import build_network
from .convert.pth import load_pth
from .ops.modulated_conv import int8_serving
from .ops.resize import resize
from .parallel.mesh import data_sharding, make_mesh
from .parallel.tiling import tiled_apply
from .utils.device import resolve_device
from .utils.img_util import imread, imwrite, tensor2img
from .utils.profiler import span

PRODUCTION_GFPGAN = dict(
    type="GFPGANv1OCR", input_width=256, input_height=256,
    num_style_feat=256, channel_multiplier=0.5, num_mlp=4,
    input_is_latent=True, different_w=True, narrow=1, sft_half=True)
SRVGG_X4 = dict(type="SRVGGNetCompact", num_feat=64, num_conv=32, upscale=4)
# ESRGAN ×4 (RealESRGAN_x4plus), the JAX CLI's --arch rrdbnet
RRDBNET_X4 = dict(type="RRDBNet", num_in_ch=3, num_out_ch=3, scale=4,
                  num_feat=64, num_block=23, num_grow_ch=32)
SR_MEAN_STD = dict(mean=(0, 0, 0), std=(1, 1, 1), out_min_max=(0, 1))
# the registered archs whose forward maps one NHWC image to an image (a
# tuple output is reduced to its first entry, as JAX's `fwd` does)
IMAGE_ARCHS = ("GFPGANv1OCR", "GFPGANv1", "SRVGGNetCompact", "RRDBNet",
               "MSRResNet", "EDSR", "RCAN", "RIDNet", "SPADEGenerator",
               "HiFaceGAN")
_NOT_IMAGE_ARCHS = {
    "DFDNet": "its forward takes the part boxes and a component "
              "dictionary beside the image",
    "StyleGAN2Generator": "it maps style codes to images, not images",
    "StyleGAN2OCRGenerator": "it maps style codes to images, not images",
    **{k: "it is a video network: its forward takes a clip (N, T, H, W, C)"
       for k in ("EDVR", "BasicVSR", "IconVSR", "DUF", "TOFlow")},
    "SpyNet": "it estimates optical flow between two frames",
    "EDVRFeatureExtractor": "it is a feature extractor of EDVR",
}
QUANT_MODES = (None, "dyn-int8")


class Restorer:
    """Restoration wrapper around any arch of `IMAGE_ARCHS` (the SR nets
    take `SR_MEAN_STD`'s normalization from the caller); another arch
    raises with its name and the reason.

    Without `ckpt_path` the weights are drawn from a generator seeded with
    `seed`; `ckpt_path` loads a reference `.pth` strictly
    (`convert/pth.py`; HiFaceGAN's spectral-norm triples fold as they
    load). `device=None` means "cuda" and raises without a GPU.

    data_parallel=N serves over N devices of this process (`devices`, by
    default cuda:0 … cuda:N−1; N above the CUDA device count raises, as
    JAX's raises above its local devices): one replica of the net each, a
    batch padded up to a multiple of N with copies of its last image, split
    in order, run on every replica at once (a worker thread per device)
    and concatenated back in order; `restore_tiled*` spread their tile
    chunks the same way (`tiled_apply(mesh=...)`).

    quant="dyn-int8" runs every conv of `ops/modulated_conv.py` (the whole
    StyleGAN2/GFPGAN family) with per-output-channel int8 weights and a
    per-tensor int8 activation scale taken on the fly (`int8_serving`),
    for this Restorer's forwards only; every entry point honours it.

    Each entry point runs in a root span `restorer.<entry point>`
    (`restorer.call` for `__call__`; `utils/profiler.py`) over the spans
    `restorer.h2d` (the input to the device), `restorer.forward` (issuing
    the forward; the tiled entries have the tiler's spans instead) and
    `restorer.d2h` (the output to host memory, which first waits for the
    device work queued before the copy).
    """

    def __init__(self, network_opt: dict, ckpt_path: Optional[str] = None,
                 param_key: str = "params_ema", dtype=None,
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                 out_min_max=(-1, 1), quant: Optional[str] = None,
                 data_parallel: Optional[int] = None, device=None,
                 seed: int = 0, devices: Optional[Sequence] = None):
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r}")
        self.data_parallel = data_parallel or 0
        if self.data_parallel:
            if devices is None:
                count = torch.cuda.device_count()
                if self.data_parallel > count:
                    raise ValueError(f"data_parallel={self.data_parallel} > "
                                     f"{count} local devices")
                devices = [f"cuda:{i}" for i in range(self.data_parallel)]
            elif len(devices) != self.data_parallel:
                raise ValueError(f"data_parallel={self.data_parallel} with "
                                 f"{len(devices)} devices")
            device = devices[0]
        self.device = resolve_device(device)
        opt = dict(network_opt)
        if dtype is not None:
            opt["dtype"] = dtype
        if opt["type"] not in IMAGE_ARCHS:
            why = _NOT_IMAGE_ARCHS.get(
                opt["type"], "it is not an image-to-image network")
            raise NotImplementedError(
                f"Restorer({opt['type']}): {why}; Restorer serves "
                f"{', '.join(IMAGE_ARCHS)}")
        self.arch = opt["type"]
        self.quant = quant
        self.net = build_network(opt, torch.Generator().manual_seed(seed))
        if ckpt_path:
            sd = load_pth(ckpt_path, param_key,
                          input_is_latent=opt.get("input_is_latent", False))
            self.net.load_state_dict(sd, strict=True)
        self.net.to(self.device).eval().requires_grad_(False)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._mean_t = torch.as_tensor(self.mean, device=self.device)
        self._std_t = torch.as_tensor(self.std, device=self.device)
        self.out_min_max = out_min_max
        self.input_size = (opt.get("input_height"), opt.get("input_width"))
        self.mesh = None
        if self.data_parallel:
            self.mesh = make_mesh(devices)
            self.replicas = [self] + [self._replica(d)
                                      for d in self.mesh.devices[1:]]

    def _replica(self, device) -> "Restorer":
        """A shallow copy of this Restorer whose net, mean and std live on
        `device`."""
        r = copy.copy(self)
        r.device = torch.device(device)
        r.net = copy.deepcopy(self.net).to(r.device)
        r._mean_t = self._mean_t.to(r.device)
        r._std_t = self._std_t.to(r.device)
        r.mesh = None
        return r

    def _dp(self, fn_name: str, x: torch.Tensor) -> torch.Tensor:
        """`fn_name` of every replica on its part of the batch `x` (padded
        up to a multiple of the replicas with its last image), the outputs
        in order, cut to x's length."""
        n = x.shape[0]
        pad = -n % self.mesh.size
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
        outs = self.mesh.run([getattr(r, fn_name) for r in self.replicas],
                             data_sharding(self.mesh)(x))
        return torch.cat([o.to(self.device) for o in outs], dim=0)[:n]

    def _resize_in(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_size[0] is not None and (
                x.shape[1] != self.input_size[0]
                or x.shape[2] != self.input_size[1]):
            x = resize(x, self.input_size, "bilinear")
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The normalized forward on the device, in this Restorer's quant
        mode. No grad mode of its own, so `torch.export` can trace it; the
        entry points run it under `inference_mode` (`_fwd`)."""
        x = self._resize_in(x)
        if self.quant == "dyn-int8":
            with int8_serving():
                return self._net_out(x)
        return self._net_out(x)

    def _net_out(self, x: torch.Tensor) -> torch.Tensor:
        if self.arch in ("GFPGANv1OCR", "GFPGANv1"):
            return self.net(x, return_rgb=False)[0]
        out = self.net(x)
        return out[0] if isinstance(out, tuple) else out

    def forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """uint8 RGB (N,H,W,3) on the device → uint8 BGR: /255, normalize,
        forward, clip, rescale, BGR flip and rounding, all on the device
        (the graph that `scripts/export_gfpgan.py` exports)."""
        x = x_u8.float() / 255.0
        x = (x - self._mean_t) / self._std_t
        out = self.forward(x)
        lo, hi = self.out_min_max
        y = torch.clamp(out.float(), lo, hi)
        y = (y - lo) / (hi - lo)
        y = torch.flip(y, dims=(-1,))  # rgb2bgr, as tensor2img does
        return torch.round(y * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x)

    @torch.inference_mode()
    def _fwd_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        return self.forward_u8(x_u8)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        with span("restorer.h2d"):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device)

    def _run(self, fn_name: str, x: torch.Tensor) -> torch.Tensor:
        """`fn_name` (`_fwd`/`_fwd_u8`) on x, over the replicas with
        data_parallel."""
        with span("restorer.forward"):
            return self._dp(fn_name, x) if self.mesh else \
                getattr(self, fn_name)(x)

    @staticmethod
    def _to_host(out: torch.Tensor) -> np.ndarray:
        with span("restorer.d2h"):
            return out.cpu().numpy()

    def restore_batch(self, imgs: np.ndarray) -> np.ndarray:
        """(N,H,W,3) RGB float [0,1] → (N,H',W',3) BGR uint8, normalized on
        the host (the reference-exact path)."""
        with span("restorer.restore_batch"):
            x = self._to_device(((imgs - self.mean) / self.std)
                                .astype(np.float32))
            out_np = self._to_host(self._run("_fwd", x).float())
            return np.stack([tensor2img(out_np[i:i + 1],
                                        min_max=self.out_min_max)
                             for i in range(out_np.shape[0])])

    def restore_batch_u8(self, imgs: np.ndarray) -> np.ndarray:
        """(N,H,W,3) RGB uint8 → (N,H',W',3) BGR uint8 with uint8 on the
        wire both ways: /255, normalize, clip, rescale, BGR flip and rounding
        run on the device. Within 1 LSB of `restore_batch(imgs / 255)`."""
        if imgs.dtype != np.uint8:
            raise TypeError(f"restore_batch_u8 expects uint8, got "
                            f"{imgs.dtype}")
        with span("restorer.restore_batch_u8"):
            x = self._to_device(imgs)
            return self._to_host(self._run("_fwd_u8", x))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """HWC RGB float [0,1] → HWC BGR uint8 restored."""
        with span("restorer.call"):
            x = self._to_device(((img - self.mean) / self.std)
                                .astype(np.float32)[None])
            with span("restorer.forward"):
                out = self._fwd(x)
            return tensor2img(self._to_host(out.float()),
                              min_max=self.out_min_max)

    def restore_tiled(self, img: np.ndarray, tile: int = 512, halo: int = 16,
                      scale: int = 4, tile_batch: int = 4) -> np.ndarray:
        """Halo-tiled large-image restore: (H,W,3) RGB float [0,1] →
        (H·scale, W·scale, 3) BGR uint8, the tiles run `tile_batch` at a
        time (`parallel/tiling.py`), over the replicas with data_parallel
        (tile_batch rounded up to a multiple of them)."""
        with span("restorer.restore_tiled"):
            x = self._to_device(((img - self.mean) / self.std)
                                .astype(np.float32)[None])
            out = tiled_apply(self._tile_fn("_fwd"), x, tile=tile,
                              halo=halo, scale=scale, tile_batch=tile_batch,
                              mesh=self.mesh)
            return tensor2img(self._to_host(out.float()),
                              min_max=self.out_min_max)

    def restore_tiled_u8(self, img: np.ndarray, tile: int = 512,
                         halo: int = 16, scale: int = 4,
                         tile_batch: int = 4) -> np.ndarray:
        """Device-IO tiled restore: (H,W,3) RGB uint8 → (H·s,W·s,3) BGR
        uint8, with the conversions of `restore_batch_u8` inside each
        chunk; within 1 LSB of `restore_tiled(img / 255)`."""
        if img.dtype != np.uint8:
            raise TypeError(f"restore_tiled_u8 expects uint8, got "
                            f"{img.dtype}")
        with span("restorer.restore_tiled_u8"):
            out = tiled_apply(self._tile_fn("_fwd_u8"),
                              self._to_device(img)[None], tile=tile,
                              halo=halo, scale=scale, tile_batch=tile_batch,
                              mesh=self.mesh)
            return self._to_host(out[0])

    def _tile_fn(self, fn_name: str):
        """The chunk function(s) of `tiled_apply`: one per replica."""
        if self.mesh is None:
            return getattr(self, fn_name)
        return [getattr(r, fn_name) for r in self.replicas]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Restore plate/car images")
    parser.add_argument("--input", type=str, required=True,
                        help="image file or glob")
    parser.add_argument("--output", type=str, default="results")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="reference .pth checkpoint to load")
    parser.add_argument("--arch", type=str, default="gfpgan_ocr",
                        choices=["gfpgan_ocr", "rrdbnet", "srvgg"])
    parser.add_argument("--tile", type=int, default=0,
                        help=">0 enables halo-tiled inference")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    if args.arch == "gfpgan_ocr":
        net_opt, mean_std = PRODUCTION_GFPGAN, {}
    elif args.arch == "srvgg":
        net_opt, mean_std = SRVGG_X4, SR_MEAN_STD
    else:
        net_opt, mean_std = RRDBNET_X4, SR_MEAN_STD
    restorer = Restorer(net_opt, args.ckpt,
                        dtype=torch.bfloat16 if args.bf16 else None,
                        device=args.device, **mean_std)
    os.makedirs(args.output, exist_ok=True)
    paths = sorted(glob.glob(args.input))
    if not paths:
        raise FileNotFoundError(args.input)
    for path in paths:
        img = imread(path)
        t0 = time.time()
        out = (restorer.restore_tiled(img, tile=args.tile) if args.tile
               else restorer(img))
        name = os.path.splitext(os.path.basename(path))[0]
        dst = os.path.join(args.output, f"{name}_restored.png")
        imwrite(out, dst)
        print(f"{path} -> {dst}  ({time.time() - t0:.2f}s)")


if __name__ == "__main__":
    main()
