"""The ×4 SR tile engine: SRVGGNetCompact, int8 PTQ or packed bf16, pack 2.

Port of `build_engine` in `scripts/export_restorer.py:29-153`, built in
process: a random (seeded) or `.pth` SRVGGNetCompact is calibrated on a
seeded batch, quantized per output channel with pack-2 block-diagonal
weights and an int8 sink on conv_last (or packed in bf16, `int8=False`),
and returned as a `serve` function over tiles of (batch, tile + 2·halo,
tile + 2·halo, 3) ×upscale on the device: uint8 in and out (`io="u8"`, the
exporter's `--u8-io`) or bf16 [0, 1] in and bf16 out (`io="bf16"`). Each
call of an int8 engine is 34 launches of kernel K2 at the defaults
(num_conv 32). `scripts/export_restorer.py` writes the graph as an
artifact.

`qat_ckpt` builds the int8 engine from a quantization-aware-training run
(`train.quant_opt`): its EMA weights, trained against the fake-quant twin
of this very graph, at its learned activation scales, with no calibration.
The checkpoint is the port's `ckpt_{iter}.pth` (the JAX package reads an
orbax directory); its scales and shapes are checked against the engine's
geometry before anything is built.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..archs import build_network
from ..convert.pth import load_pth
from ..ops.packed_inference import pack_srvgg_params, packed_srvgg_forward
from ..ops.quantized_inference import (calibrate_srvgg_act_scales,
                                       quantize_srvgg_params,
                                       quantized_srvgg_forward)
from ..utils.device import resolve_device


def build_srvgg(num_feat: int = 64, num_conv: int = 32, upscale: int = 4,
                pth: Optional[str] = None, seed: int = 0, device=None):
    """The engine's float SRVGGNetCompact (PReLU), on `device`: weights
    from a Real-ESRGAN `.pth`, or drawn from a generator seeded with
    `seed`."""
    net = build_network(dict(type="SRVGGNetCompact", num_feat=num_feat,
                             num_conv=num_conv, upscale=upscale),
                        torch.Generator().manual_seed(seed))
    if pth:
        net.load_state_dict(load_pth(pth), strict=True)
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def load_qat_checkpoint(path: str, num_feat: int, num_conv: int,
                        upscale: int):
    """(SRVGG state_dict, scales) of a `ckpt_{iter}.pth` of a quant_opt run
    (its EMA weights, else its trained ones), checked against the engine's
    num_feat, num_conv and upscale."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "qscale" not in state:
        raise ValueError(f"{path} has no qscale: not a checkpoint of a "
                         "train.quant_opt run")
    sd = state.get("ema_g") or state["params_g"]
    qscale = [float(s) for s in state["qscale"].tolist()]
    if len(qscale) != num_conv + 3:
        raise ValueError(f"checkpoint num_conv mismatch: {len(qscale) - 3} "
                         f"vs {num_conv}")
    if min(qscale) <= 0.0:
        raise ValueError(
            "checkpoint qscale contains untrained (<= 0) activation scales "
            "— it was saved before any QAT training step")
    # the round-trip gate compares the engine with the same graph, so it
    # cannot catch a wrong geometry: check the checkpoint's own shapes
    feat_ck = sd["body.0.weight"].shape[0]
    out_ck = sd[f"body.{2 * (num_conv + 1)}.weight"].shape[0]
    if feat_ck != num_feat:
        raise ValueError(f"checkpoint num_feat mismatch: {feat_ck} vs "
                         f"{num_feat}")
    if out_ck != 3 * upscale ** 2:
        raise ValueError(
            f"checkpoint upscale mismatch: conv_last has {out_ck} output "
            f"channels, expected {3 * upscale ** 2} for upscale={upscale}")
    return sd, qscale


def build_graph(num_feat: int = 64, num_conv: int = 32, upscale: int = 4,
                tile: int = 512, halo: int = 8, batch: int = 8,
                pth: Optional[str] = None, int8: bool = True,
                calib: Optional[np.ndarray] = None, seed: int = 0,
                io: str = "u8", qat_ckpt: Optional[str] = None,
                device=None) -> Tuple[Callable, dict]:
    """Returns (graph, meta): the serving function with no grad mode of its
    own (what torch.export traces) and the engine's metadata.

    calib: (N, H, W, 3) float [0, 1] calibration images; by default the
    same seeded uniform batch as the JAX package's exporter (2 × 128²).
    io="u8": the graph takes uint8 [0, 255] tiles and returns uint8, with
    the /255 and the clip and round inside; io="bf16": bf16 tiles in [0, 1]
    in, bf16 out. int8=False serves the packed bf16 path instead of the
    int8 one. qat_ckpt: a quant_opt run's `ckpt_{iter}.pth` (int8 only; no
    `pth`).
    """
    if io not in ("u8", "bf16"):
        raise ValueError(f"unknown io {io!r}")
    device = resolve_device(device)
    if qat_ckpt:
        if pth:
            raise ValueError("--pth and --qat-ckpt are mutually exclusive "
                             "(the checkpoint carries the weights)")
        if not int8:
            raise ValueError("--bf16 conflicts with --qat-ckpt: a QAT "
                             "checkpoint is trained for the int8 serving "
                             "graph; drop --bf16 (or export the float EMA "
                             "params via the regular path)")
        sd, scales = load_qat_checkpoint(qat_ckpt, num_feat, num_conv,
                                         upscale)
        net = build_srvgg(num_feat, num_conv, upscale, seed=seed,
                          device="cpu")
        net.load_state_dict(sd, strict=True)
        net = net.to(device)
    else:
        net = build_srvgg(num_feat, num_conv, upscale, pth, seed, device)
        if int8:
            if calib is None:
                rng = np.random.default_rng(seed)
                rng.random((1, 64, 64, 3), np.float32)  # the exporter's init
                calib = rng.random((2, 128, 128, 3), np.float32)
            scales = calibrate_srvgg_act_scales(
                net, torch.from_numpy(np.asarray(calib, np.float32))
                .to(device)).tolist()
    if int8:
        q = quantize_srvgg_params(net, scales, pack=2)

        def inner(x):
            return quantized_srvgg_forward(q, x, num_conv, upscale, pack=2)
    else:
        packed = pack_srvgg_params(net)

        def inner(x):
            return packed_srvgg_forward(packed, x, num_conv, upscale)

    if io == "u8":
        def graph(x_u8):
            y = inner(x_u8.to(torch.bfloat16) / 255.0)
            y = torch.clamp(y.float(), 0.0, 1.0)
            return torch.round(y * 255.0).to(torch.uint8)
    else:
        graph = inner

    size = tile + 2 * halo
    meta = {"model": "SRVGGNetCompact", "num_feat": num_feat,
            "num_conv": num_conv, "upscale": upscale, "tile": tile,
            "halo": halo, "batch": batch, "mode": "int8" if int8 else "bf16",
            "io": io, "input_shape": [batch, size, size, 3],
            "input_dtype": "uint8" if io == "u8" else "bfloat16",
            "qat": bool(qat_ckpt), "platforms": [torch.device(device).type],
            "device": str(device)}
    return graph, meta


def build_engine(**kwargs) -> Tuple[Callable, dict]:
    """Returns (serve, meta): `build_graph(**kwargs)`'s graph run under
    `inference_mode`, and its metadata."""
    graph, meta = build_graph(**kwargs)
    return torch.inference_mode()(graph), meta
