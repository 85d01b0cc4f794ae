"""Exported serving engines: the artifact format and its loaders.

Port of `image_restoration_tpu/serve/engine_restorer.py`. An engine is the
counterpart of the reference's TorchScript and TensorRT artifacts
(api_plate_oto.py:336): a source-free graph at a frozen input shape, with
its weights inside. Where the JAX package writes a `jax.export` StableHLO
blob, the port writes a `torch.export` program:

    <dir>/engine.pt2    torch.export.save of the serving graph, weights in
    <dir>/engine.json   the JAX package's keys, plus "device"

The graph calls the port's kernels as the custom ops `irt::fused_bias_lrelu`,
`irt::int8_conv3x3_requant` and `irt::conv3x3_im2col`; loading imports their
module so the ops resolve, and the loaded program runs the same kernels as
the eager path (no `torch.compile`, no AOTInductor). An artifact runs on the
device type it was exported for, and loading it for another raises (the
JAX package's platform check).

`EngineFaceRestorer` (scripts/export_gfpgan.py) slots into
`ServiceCore(restorer=…)` and `PlatePipeline`; `EngineGeoPipeline`
(`--with-geometry`) into `PlatePipeline(geo_engine=…)`; `EngineRestorer`
(scripts/export_restorer.py) serves images of any size through the halo
tiler with `tile_batch` equal to the engine's batch, so every call sees the
frozen shape (the tiler reflect-pads the grid and zero-pads the last chunk).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.tiling import tiled_apply
from ..utils.device import resolve_device

ENGINE_FILE = "engine.pt2"
META_FILE = "engine.json"


class _Graph(nn.Module):
    """A serving function as the module torch.export takes; `modules` are
    registered so their weights are saved as the program's parameters
    (tensors the function closes over become its constants)."""

    def __init__(self, fn: Callable, modules=()):
        super().__init__()
        self.fn = fn
        self.held = nn.ModuleList(modules)

    def forward(self, *args):
        return self.fn(*args)


def export_graph(fn: Callable, example_args, modules=()):
    """torch.export of `fn` at the shapes of `example_args` (frozen), under
    no_grad: the serving graph, weights inside. `fn` runs once eagerly
    first, so the device constants its ops cache (FIR kernels, resize
    matrices; `utils.device.DeviceConstants`) exist and the program holds
    them as constants on the device."""
    with torch.no_grad():
        fn(*example_args)
        return torch.export.export(_Graph(fn, modules), tuple(example_args))


def save_engine(out_dir: str, program, meta: dict) -> int:
    """Write engine.pt2 and engine.json; returns the artifact's bytes."""
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, ENGINE_FILE)
    torch.export.save(program, path)
    with open(osp.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return osp.getsize(path)


def load_engine(engine_dir: str, device=None):
    """(callable module, meta) of an artifact, for `device` (None →
    "cuda"). Raises if it was exported for another device type."""
    from ..ops import fused_act, im2col_conv, int8_conv  # noqa: F401 (ops)

    with open(osp.join(engine_dir, META_FILE)) as f:
        meta = json.load(f)
    dev = resolve_device(device)
    want = torch.device(dev).type
    have = torch.device(meta["device"]).type
    if have != want:
        raise ValueError(f"{engine_dir} was exported for {have}, not {want}; "
                         "export it again on this device type")
    program = torch.export.load(osp.join(engine_dir, ENGINE_FILE))
    found = {t.device.type for t in (*program.state_dict.values(),
                                     *program.constants.values())
             if isinstance(t, torch.Tensor)}
    if found - {want}:
        raise ValueError(f"{engine_dir} holds tensors on {sorted(found)}, "
                         f"not {want}")
    return program.module(), meta


def _chunked_call(call, batch: int, device, *arrays):
    """Run `call` over leading-dim chunks of `arrays` (numpy), padding the
    last chunk to the engine's frozen batch by repeating its final row and
    dropping the padded outputs. Returns a list of concatenated numpy
    outputs, one per engine output."""
    n = arrays[0].shape[0]
    outs = None
    for s in range(0, n, batch):
        chunk = [a[s:s + batch] for a in arrays]
        pad = batch - chunk[0].shape[0]
        if pad:
            chunk = [np.concatenate([c, np.repeat(c[-1:], pad, 0)], 0)
                     for c in chunk]
        with torch.inference_mode():
            res = call(*[torch.from_numpy(np.ascontiguousarray(c)).to(device)
                         for c in chunk])
            if not isinstance(res, (tuple, list)):
                res = (res,)
            res = [r[:batch - pad].cpu().numpy() for r in res]
        outs = ([[r] for r in res] if outs is None
                else [o + [r] for o, r in zip(outs, res)])
    return [np.concatenate(o, 0) for o in outs]


class EngineFaceRestorer:
    """Fixed-size restorer engine (scripts/export_gfpgan.py): uint8 RGB in,
    uint8 BGR out, normalization and output conversion inside. Duck-
    compatible with Restorer's serving surface (`input_size`,
    `restore_batch_u8`, `restore_batch`, `__call__`), so it slots into
    ServiceCore(restorer=…) with micro-batching. Batches are padded and
    chunked to the engine's frozen batch."""

    def __init__(self, engine_dir: str, device=None):
        self.engine, self.meta = load_engine(engine_dir, device)
        self.device = resolve_device(device)
        if self.meta.get("geometry"):
            raise ValueError(f"{engine_dir} is a fused-geometry engine (load "
                             "it with EngineGeoPipeline)")
        shape = self.meta["input_shape"]
        self.batch = int(shape[0])
        self.input_size = (int(shape[1]), int(shape[2]))
        self.out_min_max = tuple(self.meta.get("out_min_max", (-1, 1)))

    def restore_batch_u8(self, imgs: np.ndarray) -> np.ndarray:
        """(N,H,W,3) RGB uint8 → (N,H,W,3) BGR uint8."""
        if imgs.dtype != np.uint8:
            raise TypeError(f"restore_batch_u8 expects uint8, got "
                            f"{imgs.dtype}")
        return _chunked_call(self.engine, self.batch, self.device, imgs)[0]

    def restore_batch(self, imgs: np.ndarray) -> np.ndarray:
        """(N,H,W,3) RGB float [0,1] → BGR uint8. The engine's IO is uint8,
        so float inputs are rounded to 8 bits first (≤0.5/255 input
        error)."""
        return self.restore_batch_u8(
            np.clip(np.asarray(imgs, np.float32) * 255.0 + 0.5,
                    0, 255).astype(np.uint8))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return self.restore_batch(img[None])[0]


class EngineGeoPipeline:
    """Fused post-detector pipeline engine (scripts/export_gfpgan.py
    --with-geometry): mask, crop, resize, both restores, warp, paste and
    montage in one artifact. Slots into PlatePipeline(geo_engine=…):
    `__call__((N,T,T,3) uint8 BGR canvases, (N,4,2) float32 quads)` →
    (montage_u8 (N,T,6T,3), masked_canvas_u8), padded and chunked to the
    engine's frozen batch."""

    def __init__(self, engine_dir: str, device=None):
        self.engine, self.meta = load_engine(engine_dir, device)
        self.device = resolve_device(device)
        if not self.meta.get("geometry"):
            raise ValueError(
                f"{engine_dir} is not a fused-geometry engine (export "
                "with scripts/export_gfpgan.py --with-geometry)")
        shape = self.meta["input_shape"]
        self.batch = int(shape[0])
        self.target = int(shape[1])

    def __call__(self, canvases: np.ndarray, quads: np.ndarray):
        if canvases.dtype != np.uint8:
            raise TypeError(f"expected uint8 canvases, got "
                            f"{canvases.dtype}")
        mont, masked = _chunked_call(self.engine, self.batch, self.device,
                                     canvases, np.asarray(quads, np.float32))
        return mont, masked


class EngineRestorer:
    """The ×4 SR tile engine on images of any size. Callable: RGB (H, W,
    3), uint8 [0, 255] or float [0, 1] → uint8 RGB ×upscale.

    `EngineRestorer(engine_dir)` loads an artifact of
    scripts/export_restorer.py; `EngineRestorer(serve, meta)` or
    `EngineRestorer.build(**kwargs)` wraps an engine built in process
    (`serve/sr_engine.py`). With uint8 IO (`--u8-io`) uint8 tiles go to the
    device and come back uint8 (float input is rounded to uint8 first);
    with bf16 IO the tiles go as bf16 [0, 1] and the output is clipped and
    rounded on the host."""

    def __init__(self, engine, meta: Optional[dict] = None, device=None):
        if isinstance(engine, (str, os.PathLike)):
            if meta is not None:
                raise ValueError("an engine directory carries its own meta")
            engine, meta = load_engine(str(engine), device)
        self.serve, self.meta = engine, meta
        self.tile = int(meta["tile"])
        self.halo = int(meta["halo"])
        self.batch = int(meta["batch"])
        self.upscale = int(meta["upscale"])
        self.u8_io = meta.get("io") == "u8"
        self.device = resolve_device(device if device is not None
                                     else meta["device"])

    @classmethod
    def build(cls, **kwargs) -> "EngineRestorer":
        """An engine from `serve.sr_engine.build_engine(**kwargs)`."""
        from .sr_engine import build_engine
        return cls(*build_engine(**kwargs))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.u8_io:
            if img.dtype != np.uint8:
                img = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5,
                              0, 255).astype(np.uint8)
            x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
            with torch.inference_mode():
                out = tiled_apply(self.serve, x[None], tile=self.tile,
                                  halo=self.halo, scale=self.upscale,
                                  tile_batch=self.batch)
                return out[0].cpu().numpy()
        if img.dtype == np.uint8:
            img = np.asarray(img, np.float32) / 255.0
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            self.device)
        with torch.inference_mode():
            out = tiled_apply(lambda t: self.serve(t.to(torch.bfloat16)),
                              x[None], tile=self.tile, halo=self.halo,
                              scale=self.upscale, tile_batch=self.batch)
            out = out[0].float().cpu().numpy()
        return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)
