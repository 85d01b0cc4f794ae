#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Drives the port's two main paths with random weights made from a seed, and
fails loudly if any phase fails:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every hand-written kernel (K1, K2 and K3), from csrc/, one nvcc
     per source, all started together, with ptxas's register report; a
     register spill fails the run.

Path 1, the restore server: GFPGANv1OCR at PRODUCTION_GFPGAN (256²) behind
`Restorer.restore_batch_u8` and `/Restore/`, `/RestoreConcat/`:

  3. K1 against its plain PyTorch version on the card at every (M, C) shape
     the path gives it (batch 1 and 16, plus a ragged and a scalar-path
     shape), f32 and bf16, with its device time (calls back to back), its
     plain version's, the least time the card could take, and both as the
     host issues them;
  4. main path: launch counts set to 0, then one restore at batch 1, 4 and
     16 and HTTP requests; K1 must launch exactly 39 times per forward;
  5. correctness: the net with K1 against the same net on K1's plain
     version (TF32 off, ≤1 LSB), and the card against the CPU on one image;
  6. throughput (imgs/s per batch, PyTorch's default TF32 settings) and a
     profiler breakdown of one batch-16 forward.

Path 2, the ×4 SR tile engine: SRVGGNetCompact (64 features, 32 convs),
int8 PTQ with pack-2 block-diagonal weights, tiles of 512 with a halo of 8,
8 tiles per engine call, behind `EngineRestorer` and `/SRx4/`:

  7. K2 against its plain version at each layer shape of an engine call
     (4 packed images of 528², Cin→Cout 6→128, 128→128, 128→96) in both
     epilogue modes, plus ragged shapes (the served 528 width, H = 1, tiles
     that cross images, Cout 160/192, sums of 2^22 and more that take the
     kernel's scalar epilogue): integer-exact; device times of the
     kernel and the plain version, the bound, and two library yardsticks
     (torch._int_mm on the im2col matrix, and the cuDNN bf16 conv of the
     packed bf16 path at the same shape);
  8. main path: counts set to 0, then `EngineRestorer` on a 1024×768 image
     and one POST to /SRx4/; K2 must launch exactly 34 times per engine
     chunk and K1 never;
  9. correctness (TF32 off): the chain on K2 against the chain on K2's
     plain version (int8 activations equal at every layer, bf16 output
     bit-equal), int8 against the packed bf16 path (span-normalized PSNR
     ≥ 30 dB), tiled against untiled for the float net (interior), and the
     card against the CPU on one pair of 64² tiles;
 10. throughput: ms per engine call and tiles/s for the int8 engine and the
     packed bf16 path, peak device memory, and a profiler breakdown of one
     int8 engine call.

Path 3, ESRGAN ×4: RRDBNet at RRDBNET_X4 (64 features, 23 blocks, grow 32)
behind `infer --arch rrdbnet --tile 512` and `Restorer.restore_tiled_u8`, its
packed, widened and int8 forms, and K3 behind the stage-conv probe:

 11. K3 against its plain version at the five widened stage shapes at 528²
     (bf16 and float32 out) and a ragged shape, with device times, the bound
     and each stage's share of it, cuDNN's bf16 conv, and K3 at 48×528 (one
     tile per block: a launch's fixed cost); then `probe_conv.main()`, K3's
     entry point, with the counts set to 0 before it and read after;
 12. K2's "bf16_deq" epilogue against its plain version at the five RRDB
     stage shapes at 528², one image and the ladder's batch of 4, and at
     ragged shapes, bit-equal, with device times for one image and
     torch._int_mm on the im2col matrix (the contraction alone) as the
     yardstick;
 13. main path: counts set to 0, then `infer.main(["--arch", "rrdbnet",
     "--tile", "512", ...])` on a 1024×768 PNG (4 tiles of 544²) and
     `restore_tiled_u8` on the same image, timed; the card against the CPU
     at full width and depth on a 64×48 image (TF32 off, ≤1 LSB);
 14. the `scripts/bench_rrdb.py` ladder at 528², 23 blocks: plain bf16,
     packed g=4, widened g=1/2/4 and widened int8 (K2, 345 launches per
     forward), tiles/s and peak memory, and a profile of the int8 forward;
 15. the int8 chain at 2 blocks: on K2 against K2's plain version at 528²
     (every stage input equal, output bit-equal), and against the float32
     forward at 256² (≥30 dB); the 23-block PSNR is printed.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
lists the kernels as JSON. Without a GPU, or without the port beside this
file, it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, CUDA cores, dense
BF16_OPS_PER_S = 989e12     # H100 SXM, bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12    # H100 SXM, int8 tensor cores, dense
K1_LAUNCHES_PER_FORWARD = 39
# the SR engine at the JAX exporter's defaults (scripts/export_restorer.py)
SR = dict(num_feat=64, num_conv=32, upscale=4, tile=512, halo=8, batch=8)
K2_LAUNCHES_PER_CALL = SR["num_conv"] + 2
SR_GATE_DB = 30.0           # int8 vs packed bf16, bench.py's serving gate
RECEPTIVE_RADIUS = SR["num_conv"] + 2  # 3×3 convs, in input pixels
K1_OPS_PER_ELEMENT = 4      # add, compare, two multiplies
# device_time_ms: calls per window (at most 6 launches each, well inside the
# CUDA launch queue) and the sleep that holds the stream meanwhile (about
# 20 ms on an H100, several times what the host takes to enqueue a window)
HOLD_CALLS = 50
HOLD_CYCLES = 40_000_000
ROUTE_METHODS = {"/Restore/": "restore", "/RestoreConcat/": "restore_concat"}


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(*args):
    print(*args, flush=True)


# ----------------------------------------------------------------- helpers

def plate_image(h, w, seed):
    """A synthetic licence-plate-like BGR uint8 image."""
    import cv2
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 215, np.uint8)
    cv2.rectangle(img, (2, 2), (w - 3, h - 3), (20, 20, 20), max(1, h // 40))
    text = "".join(rng.choice(list("0123456789ABCDEFGHKLMN"), 7))
    scale = h / 45.0
    cv2.putText(img, text[:3] + "-" + text[3:], (w // 12, int(h * 0.68)),
                cv2.FONT_HERSHEY_SIMPLEX, scale, (15, 15, 15),
                max(1, int(scale * 2.5)))
    img = cv2.GaussianBlur(img, (0, 0), 1.2)
    noise = rng.normal(0, 8, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def scene_image(h, w, seed):
    """A synthetic RGB uint8 street-like scene: a smooth colour field, a few
    flat shapes with hard edges, a licence plate, blur and sensor noise."""
    import cv2
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.random((h // 64 + 2, w // 64 + 2, 3)).astype(
        np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img * 200 + 30, 0, 255).astype(np.uint8)
    for _ in range(12):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        size = int(rng.integers(h // 16, h // 4))
        if rng.random() < 0.5:
            cv2.rectangle(img, (x0, y0), (x0 + size, y0 + size // 2), color,
                          -1)
        else:
            cv2.circle(img, (x0, y0), size // 2, color, -1)
    ph, pw = h // 6, h // 2
    y0, x0 = h // 2, w // 3
    img[y0:y0 + ph, x0:x0 + pw] = plate_image(ph, pw, seed)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def bf16_ulp(v):
    """One bf16 ulp of each value of v (float32)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def _warm_up(fn, arg_sets):
    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()


def host_time_ms(fn, arg_sets, iters):
    """Mean ms per call as the host issues `iters` calls, cycling through
    `arg_sets`, launch path included (CUDA events; warm-up first)."""
    _warm_up(fn, arg_sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, arg_sets, iters):
    """Mean device ms per call over `iters` calls run back to back.

    In windows of HOLD_CALLS calls, a sleep kernel holds the stream while
    the host enqueues the window, so the CUDA events time the device alone
    and not the host's launch path, which dominates small calls. A window
    whose sleep ended before the host finished is timed again; the run
    fails after three."""
    _warm_up(fn, arg_sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for first in range(0, iters, HOLD_CALLS):
        for _ in range(3):
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            for i in range(first, min(iters, first + HOLD_CALLS)):
                fn(*arg_sets[i % len(arg_sets)])
            end.record()
            held = not start.query()
            end.synchronize()
            if held:
                total += start.elapsed_time(end)
                break
        else:
            raise SystemExit("chip_smoke: FAILED: the host took longer to "
                             "enqueue a window of calls than the sleep that "
                             "held the stream, 3 times")
    return total / iters


def _kernel_events(prof):
    """(device ms, count, name) of every CUDA kernel/memcpy in a profile."""
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        rows.append((t / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def profile_call(fn, kernel_key, want, tries=3):
    """torch.profiler (CPU and CUDA) over one fn() ending in a synchronize:
    (wall ms, device kernel events, launches of the kernels whose name holds
    `kernel_key`). The profiler has dropped device events on the card, so a
    profile that holds another count than `want` is taken again, up to
    `tries` times; the caller checks the count of the last."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = _kernel_events(prof)
        seen = sum(k[1] for k in kernels if kernel_key in k[2])
        if seen == want:
            break
        log(f"profiler saw {seen} of {want} {kernel_key} launches: "
            "profiling again")
    return wall, kernels, seen


def k1_bound_ms(m, c, esize):
    """Least time for one launch: read x and bias once, write out once,
    against 4 float32 operations per element."""
    nbytes = (2 * m * c + c) * esize
    ops = K1_OPS_PER_ELEMENT * m * c
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def randomize_weights(net, seed):
    """Random init leaves every bias at its init value: draw the 1-D
    parameters too, so K1's bias path carries data. Scale the decoder's RGB
    heads by 0.15, so the output image is not mostly clipped at ±1 and the
    uint8 comparisons below see real pixel values."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.add_((0.1 * torch.randn(p.shape, generator=g)).to(p.device))
            if ".to_rgb" in name:
                p.mul_(0.15)


# ------------------------------------------------------------------ phases

def phase_device():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    line = proc.stdout.strip().splitlines()[0].strip()
    log(line)
    log(f"device: {torch.cuda.get_device_name(0)}  count="
        f"{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    return line


def phase_build():
    from image_restoration_tpu_torch.ops import _build
    t0 = time.perf_counter()
    builds = _build.build_all(["fused_bias_act", "int8_conv3x3",
                               "conv3x3_im2col"])
    total = time.perf_counter() - t0
    for b in builds:
        log(f"build {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        fences = sum("C7519" in ln for ln in b.log.splitlines())
        if fences:  # ptxas serialised wgmma it could not keep back to back
            log(f"  ptxas injected {fences} warpgroup.arrive fences")
        for ln in b.log.splitlines():
            if "spill" in ln or ("ptxas info" in ln
                                 and ("Used" in ln or "Compiling" in ln)):
                log(f"  {ln.strip()}")
            require("spill" not in ln
                    or "0 bytes spill stores, 0 bytes spill loads" in ln,
                    f"{b.name} spills registers: {ln.strip()}")
    log(f"build total {total:.2f} s")
    return {b.name: b.seconds for b in builds}


def record_k1_shapes(restorer, u8):
    """The (M, C) of each K1 call of one forward, taken on the plain
    version (no kernel launches)."""
    from image_restoration_tpu_torch.ops import fused_act
    shapes = []
    plain = fused_act.fused_leaky_relu_plain

    def rec(x, bias=None, negative_slope=0.2, scale=fused_act.SQRT2):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1]))
        return plain(x, bias, negative_slope, scale)

    with mock.patch.object(fused_act, "fused_leaky_relu", rec):
        restorer.restore_batch_u8(u8)
    return shapes


def phase_kernels(shapes_bs1):
    """K1 against its plain version at every main-path shape; times."""
    from image_restoration_tpu_torch.ops.fused_act import (
        fused_leaky_relu, fused_leaky_relu_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    distinct = sorted(set(shapes_bs1))
    cases = [(m * bs, c, bs) for bs in (1, 16) for m, c in distinct]
    cases += [(12345, 24, None), (771, 3, None)]  # ragged M; scalar path
    rows = []
    worst = 0.0
    log("K1 vs plain, tolerance: f32 max|d| <= 1e-6 * max(1, max|plain|); "
        "bf16 |d| <= 1 ulp of the plain value, element by element")
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for m, c, bs in cases:
            x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
            b = torch.randn((c,), generator=gen, device="cuda")
            got = fused_leaky_relu(x, b)
            want = fused_leaky_relu_plain(x, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                tol = 1e-6 * max(1.0, want.abs().max().item())
                ok = err.max().item() <= tol
            else:  # one bf16 ulp of the plain value
                ok = bool((err <= bf16_ulp(want.float())).all())
            max_err = err.max().item()
            require(ok, f"K1 {dtype} M={m} C={c}: max|d|={max_err}")
            worst = max(worst, max_err)
            nbytes = 2 * m * c * esize
            nbuf = max(1, min(32, math.ceil(256e6 / nbytes)))
            xs = [(x,)] + [(torch.randn((m, c), generator=gen, device="cuda")
                            .to(dtype),) for _ in range(nbuf - 1)]
            iters = max(20, min(200, int(4e9 / nbytes)))
            kern = lambda t: fused_leaky_relu(t, b)  # noqa: E731
            plain = lambda t: fused_leaky_relu_plain(t, b)  # noqa: E731
            row = dict(dtype=str(dtype).replace("torch.", ""), M=m, C=c,
                       batch=bs,
                       per_forward=(shapes_bs1.count((m // bs, c))
                                    if bs else 0),
                       ms=device_time_ms(kern, xs, iters),
                       plain_ms=device_time_ms(plain, xs, iters),
                       call_ms=host_time_ms(kern, xs, iters),
                       plain_call_ms=host_time_ms(plain, xs, iters),
                       bound_ms=k1_bound_ms(m, c, esize), max_abs_err=max_err)
            del xs
            rows.append(row)
            log(f"K1 {row['dtype']:8s} M={m:8d} C={c:4d} bs={bs} "
                f"x{row['per_forward']}/fwd  ms={row['ms']:.5f}  "
                f"plain_ms={row['plain_ms']:.5f}  "
                f"bound_ms={row['bound_ms']:.5f}  "
                f"call_ms={row['call_ms']:.5f}  "
                f"plain_call_ms={row['plain_call_ms']:.5f}  "
                f"max|d|={max_err:.3g}")
    torch.cuda.empty_cache()
    agg = {}
    for dt in ("float32", "bfloat16"):
        for bs in (1, 16):
            sel = [r for r in rows if r["dtype"] == dt and r["batch"] == bs]
            agg[(dt, bs)] = {k: sum(r[k] * r["per_forward"] for r in sel)
                             for k in ("ms", "plain_ms", "bound_ms",
                                       "call_ms", "plain_call_ms")}
            require(sum(r["per_forward"] for r in sel)
                    == K1_LAUNCHES_PER_FORWARD, "shape multiplicities")
            a = agg[(dt, bs)]
            log(f"K1 per forward {dt} bs={bs}: ms={a['ms']:.4f}  "
                f"plain_ms={a['plain_ms']:.4f}  bound_ms={a['bound_ms']:.4f}  "
                f"call_ms={a['call_ms']:.4f}  "
                f"plain_call_ms={a['plain_call_ms']:.4f}")
    return rows, agg, worst


def post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=body,
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def phase_main_path(restorer, batches, per_forward=K1_LAUNCHES_PER_FORWARD):
    """Counts at 0, then the main path: restores at batch 1/4/16 and four
    HTTP requests. Returns K1's launch count over the whole run."""
    size = restorer.input_size[0]
    import cv2
    from image_restoration_tpu_torch.ops.fused_act import fused_leaky_relu
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server

    fused_leaky_relu.launches = 0
    expected = 0
    for bs, u8 in batches.items():
        before = fused_leaky_relu.launches
        out = restorer.restore_batch_u8(u8)
        torch.cuda.synchronize()
        require(out.dtype == np.uint8 and out.shape == (bs, size, size, 3),
                f"restore bs={bs}: {out.dtype} {out.shape}")
        n = fused_leaky_relu.launches - before
        require(n == per_forward,
                f"bs={bs}: K1 launched {n} times, expected {per_forward}")
        expected += n
        log(f"restore_batch_u8 bs={bs}: uint8 {out.shape}, K1 launches {n}")

    core = ServiceCore(restorer)
    server = make_server(core, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    timings = []
    try:
        requests = [("/Restore/", (120, 360), (size, size, 3)),
                    ("/Restore/", (300, 300), (size, size, 3)),
                    ("/Restore/", (480, 640), (size, size, 3)),
                    ("/RestoreConcat/", (90, 270), (size, 2 * size, 3))]
        bodies = []
        for i, (route, hw, shape) in enumerate(requests):
            ok, buf = cv2.imencode(".jpg", plate_image(*hw, seed=100 + i))
            require(ok, f"JPEG encode of a {hw} image")
            bodies.append(buf)
            before = fused_leaky_relu.launches
            t0 = time.perf_counter()
            status, media, body = post(port, route, buf.tobytes())
            dt = (time.perf_counter() - t0) * 1e3
            img = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            require(status == 200 and media == "image/jpeg",
                    f"{route}: {status} {media}")
            require(img is not None and img.shape == shape,
                    f"{route}: decoded {None if img is None else img.shape}")
            n = fused_leaky_relu.launches - before
            require(n == per_forward, f"{route}: K1 launched {n} times")
            expected += n
            timings.append(dt)
            log(f"POST {route} {hw[1]}x{hw[0]} jpeg -> 200 {shape}  "
                f"{dt:.2f} ms")
        for (route, hw, _), buf in zip(requests, bodies):
            t0 = time.perf_counter()
            status, _, _ = post(port, route, buf.tobytes())
            t1 = time.perf_counter()
            require(status == 200, f"{route} again: {status}")
            getattr(core, ROUTE_METHODS[route])(
                cv2.imdecode(buf, cv2.IMREAD_COLOR))
            t2 = time.perf_counter()
            log(f"again POST {route} {hw[1]}x{hw[0]}: {(t1 - t0) * 1e3:.2f} "
                f"ms; the same ServiceCore call without HTTP: "
                f"{(t2 - t1) * 1e3:.2f} ms")
            expected += 2 * per_forward
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    launches = fused_leaky_relu.launches
    require(launches == expected, f"K1 count {launches} != {expected}")
    log(f"main path: K1 launches {launches}")
    return launches, timings


def phase_correctness(restorer, u8_4, u8_1):
    """Kernel vs plain K1 in the whole net (TF32 off, ≤1 LSB) and the card
    against the CPU on one image."""
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer
    from image_restoration_tpu_torch.ops import fused_act

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = restorer.restore_batch_u8(u8_4)
        x = torch.from_numpy(u8_4).cuda().float() / 255.0
        x = (x - restorer._mean_t) / restorer._std_t
        got_f = restorer._fwd(x)
        again_f = restorer._fwd(x)
        log("net with K1, run to run (bs=4, TF32 off): float max|d| "
            f"{(got_f - again_f).abs().max().item():.3g}")
        with mock.patch.object(fused_act, "fused_leaky_relu",
                               fused_act.fused_leaky_relu_plain):
            want = restorer.restore_batch_u8(u8_4)
            want_f = restorer._fwd(x)
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        df = (got_f - want_f).abs().max().item()
        log(f"net with K1 vs net with plain K1 (bs=4, TF32 off): "
            f"uint8 max {d.max()} LSB, float max|d| {df:.3g}")
        require(d.max() <= 1, f"K1 net vs plain net: {d.max()} LSB")
        require(bool(torch.isfinite(got_f).all()), "non-finite output")
        y = got_f.float()
        log(f"output stats: mean {y.mean().item():.4f} std "
            f"{y.std().item():.4f} clipped "
            f"{(y.abs() >= 1).float().mean().item():.4f}")
        require(y.std().item() > 1e-3, "constant output")

        cpu = Restorer(PRODUCTION_GFPGAN, device="cpu")
        cpu.net.load_state_dict(restorer.net.state_dict())
        ref = cpu.restore_batch_u8(u8_1)
        gpu = restorer.restore_batch_u8(u8_1)
        dc = np.abs(ref.astype(np.int16) - gpu.astype(np.int16))
        log(f"card vs CPU (bs=1, TF32 off): uint8 max {dc.max()} LSB, "
            f"mean {dc.mean():.5f}, share >1 LSB {(dc > 1).mean():.6f}")
        require(dc.max() <= 4 and dc.mean() <= 0.05,
                f"card vs CPU: max {dc.max()} mean {dc.mean()}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return int(d.max()), float(df), int(dc.max())


def phase_throughput(restorer, batches):
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        "(PyTorch defaults)")
    out = {}
    for bs, u8 in batches.items():
        for _ in range(3):
            restorer.restore_batch_u8(u8)
        torch.cuda.synchronize()
        iters = {1: 40, 4: 30, 16: 20}.get(bs, 20)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            restorer.restore_batch_u8(u8)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[bs] = dict(imgs_per_s=bs / med, ms_per_batch=med * 1e3,
                       ms_min=min(times) * 1e3, ms_max=max(times) * 1e3)
        log(f"restore_batch_u8 bs={bs}: {out[bs]['imgs_per_s']:.2f} imgs/s "
            f"(median {out[bs]['ms_per_batch']:.3f} ms/batch, min "
            f"{out[bs]['ms_min']:.3f}, max {out[bs]['ms_max']:.3f}, "
            f"{iters} calls)")
    torch.cuda.reset_peak_memory_stats()
    restorer.restore_batch_u8(batches[16])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"peak device memory bs=16: {peak:.1f} MiB")
    return out, peak


def phase_profile(restorer, u8):
    """Device time by kernel over one batch-16 restore (torch.profiler)."""
    restorer.restore_batch_u8(u8)
    torch.cuda.synchronize()
    wall_ms, kernels, k1_n = profile_call(
        lambda: restorer.restore_batch_u8(u8), "fused_bias_lrelu",
        K1_LAUNCHES_PER_FORWARD)
    busy = sum(k[0] for k in kernels)
    k1_ms = sum(k[0] for k in kernels if "fused_bias_lrelu" in k[2])
    log(f"profile bs=16: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%), K1 {k1_ms:.4f} ms over {k1_n} "
        "launches")
    for t, n, name in kernels[:15]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    require(k1_n == K1_LAUNCHES_PER_FORWARD,
            f"profiler saw {k1_n} K1 launches")
    return dict(wall_ms=wall_ms, busy_ms=busy, k1_device_ms=k1_ms,
                top=[dict(ms=t, count=n, name=name[:200])
                     for t, n, name in kernels[:25]])


# ----------------------------------------------------- path 2: SR engine

def k2_bound_ms(n, h, w, cin, cout):
    """Least time for one SAME-padded launch: 2·MACs (the block-diagonal
    zeros included, as the kernel computes them) over the int8 tensor-core
    peak, or x, weights and out once over the memory rate, the larger."""
    ops = 2 * n * h * w * cout * 9 * cin
    nbytes = n * h * w * (cin + cout) + cout * 9 * cin + 3 * cout * 2
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3, (
        "operations" if ops / INT8_OPS_PER_S >= nbytes / HBM_BYTES_PER_S
        else "bytes")


def k2_layer_shapes():
    """(name, Cin, Cout, launches per engine call, PReLU) of the chain."""
    f, oc = SR["num_feat"] * 2, 3 * SR["upscale"] ** 2 * 2
    return [("body_0", 6, f, 1, True),
            (f"body_1..{SR['num_conv']}", f, f, SR["num_conv"], True),
            ("conv_last", f, oc, 1, False)]


def k2_inputs(gen, n, h, w, cin, cout, epilogue, prelu):
    """Random int8 x and weights, and epilogue vectors that spread |acc·deq|
    to about 100, so rounding and the ±127 clip both matter."""
    from image_restoration_tpu_torch.ops.int8_conv import EPILOGUES
    pdt = EPILOGUES[epilogue][1]
    x = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                      device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, 3, 3, cin), generator=gen,
                       device="cuda", dtype=torch.int8)
    scale = 100.0 / (math.sqrt(9 * cin) * 127 ** 2 / 3)
    deq = (torch.rand(cout, generator=gen, device="cuda") * scale).to(pdt)
    b = (torch.randn(cout, generator=gen, device="cuda") * 5).to(pdt)
    a = torch.rand(cout, generator=gen, device="cuda").to(pdt)
    return x, wt, deq, b, (a if prelu else None)


def saturate(x, wt):
    """Sums of 2^22 and more in one corner (Cin >= 32, H and W > 8): the
    kernel's threads holding them take its scalar epilogue."""
    if x.shape[1] > 8 and x.shape[2] > 8 and x.shape[3] >= 32:
        x[:, :5, :6] = 127
        wt[:min(wt.shape[0], 9)] = 127


def im2col(x, cin_to):
    """(N, H, W, C) int8 → (N·H·W, 9·cin_to), taps major, channels minor:
    the A of the SAME conv as one matrix product (the weights' (Cout, 3, 3,
    Cin) reshaped is B)."""
    n, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, cin_to - c, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1).reshape(n * h * w,
                                                           9 * cin_to)


def phase_k2_kernels():
    """K2 against its plain version at each layer shape of an engine call,
    both epilogues (integer-exact), with times and yardsticks; then ragged
    shapes, exactness only."""
    import torch.nn.functional as F
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant, int8_conv3x3_requant_plain)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = SR["batch"] // 2
    s = SR["tile"] + 2 * SR["halo"]
    rows = []
    log("K2 vs plain, tolerance: integer-exact (max|d| == 0); times are "
        "device ms per launch at the engine's shapes (N=4 packed images of "
        f"{s}²)")
    for name, cin, cout, per_call, prelu in k2_layer_shapes():
        bound, bound_by = k2_bound_ms(n, s, s, cin, cout)
        for epilogue in ("bf16", "f32"):
            x, wt, deq, b, a = k2_inputs(gen, n, s, s, cin, cout, epilogue,
                                         prelu)
            got = int8_conv3x3_requant(x, wt, deq, b, a, 64.0,
                                       epilogue=epilogue)
            want = int8_conv3x3_requant_plain(x, wt, deq, b, a, 64.0,
                                              epilogue=epilogue)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            clipped = (got.abs() == 127).float().mean().item()
            require(err == 0, f"K2 {name} {epilogue}: max|d| {err}")
            del got, want
            row = dict(layer=name, epilogue=epilogue, N=n, H=s, W=s,
                       Cin=cin, Cout=cout, per_call=per_call,
                       max_abs_err=err, share_clipped=clipped,
                       bound_ms=bound, bound_by=bound_by)
            row["ms"] = device_time_ms(
                lambda t: int8_conv3x3_requant(t, wt, deq, b, a, 64.0,
                                               epilogue=epilogue),
                [(x,)], 20)
            row["plain_ms"] = device_time_ms(
                lambda t: int8_conv3x3_requant_plain(t, wt, deq, b, a, 64.0,
                                                     epilogue=epilogue),
                [(x,)], 3)
            if epilogue == "bf16":
                cpad = -(-cin // 8) * 8
                a_mat = im2col(x, cpad)
                b_mat = F.pad(wt, (0, cpad - cin)).reshape(cout, 9 * cpad).t()
                acc = torch._int_mm(a_mat, b_mat)
                ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                               wt.permute(0, 3, 1, 2).double(), padding=1)
                require(torch.equal(acc.double(), ref.permute(0, 2, 3, 1)
                                    .reshape(-1, cout)),
                        f"_int_mm yardstick differs from the conv ({name})")
                del acc, ref
                row["int_mm_ms"] = device_time_ms(
                    lambda t: torch._int_mm(t, b_mat), [(a_mat,)], 20)
                del a_mat
                xb = x.permute(0, 3, 1, 2).bfloat16()  # channels_last memory
                wb = wt.permute(0, 3, 1, 2).bfloat16().contiguous(
                    memory_format=torch.channels_last)
                row["cudnn_bf16_ms"] = device_time_ms(
                    lambda t: F.conv2d(t, wb, padding=1), [(xb,)], 20)
                del xb, wb
            rows.append(row)
            log(f"K2 {name:10s} {epilogue:4s} {cin:3d}->{cout:3d} "
                f"x{per_call}/call  ms={row['ms']:.4f}  "
                f"plain_ms={row['plain_ms']:.4f}  bound_ms={bound:.4f} "
                f"({bound_by})  int_mm_ms={row.get('int_mm_ms', 0):.4f}  "
                f"cudnn_bf16_ms={row.get('cudnn_bf16_ms', 0):.4f}  "
                f"clipped={clipped:.4f}  max|d|={err}")
            del x
            torch.cuda.empty_cache()
    for n_, h, w, cin, cout, pad in [(3, 37, 45, 10, 24, 1),
                                     (3, 37, 45, 10, 24, 0),
                                     (1, 5, 3, 6, 128, 1),
                                     (2, 25, 528, 6, 96, 1),
                                     (1, 1, 40, 64, 192, 1),
                                     (3, 64, 136, 32, 160, 1),
                                     (1, 9, 30, 128, 192, 1)]:
        for epilogue in ("bf16", "f32"):
            for prelu in (True, False):
                x, wt, deq, b, a = k2_inputs(gen, n_, h, w, cin, cout,
                                             epilogue, prelu)
                saturate(x, wt)
                got = int8_conv3x3_requant(x, wt, deq, b, a, 64.0, pad=pad,
                                           epilogue=epilogue)
                want = int8_conv3x3_requant_plain(x, wt, deq, b, a, 64.0,
                                                  pad=pad, epilogue=epilogue)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"K2 ragged {(n_, h, w, cin, cout, pad)} {epilogue} "
                        f"prelu={prelu}")
    log("K2 ragged shapes (odd H and W, 528 wide, H 1, 176 and 144 tiles, "
        "Cin 6/10/32/64/128, Cout 24/96/128/160/192, sums >= 2^22 in a "
        "corner, pad 0 and 1, with and without PReLU, both epilogues): "
        "integer-exact")
    per_call = {k: sum(r[k] * r["per_call"] for r in rows
                       if r["epilogue"] == "bf16")
                for k in ("ms", "plain_ms", "bound_ms", "int_mm_ms",
                          "cudnn_bf16_ms")}
    log(f"K2 per engine call ({K2_LAUNCHES_PER_CALL} launches, bf16 "
        "epilogue): "
        + "  ".join(f"{k}={v:.4f}" for k, v in per_call.items()))
    return rows, per_call


def sr_calib():
    """Two 128² float crops of a seeded synthetic scene (the exporter's
    calibration batch size)."""
    img = scene_image(384, 512, seed=7).astype(np.float32) / 255.0
    return np.stack([img[40:168, 60:188], img[200:328, 300:428]])


def build_sr(int8=True):
    from image_restoration_tpu_torch.serve.engine_restorer import (
        EngineRestorer)
    return EngineRestorer.build(int8=int8, calib=sr_calib(), seed=0,
                                device="cuda", **SR)


def phase_sr_main_path(restorer, engine):
    """Counts at 0, then the SR path: EngineRestorer on a 1024×768 image and
    one POST to /SRx4/. Returns K2's launch count over the run."""
    import cv2
    from image_restoration_tpu_torch.ops.fused_act import fused_leaky_relu
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    from image_restoration_tpu_torch.serve.api import ServiceCore, make_server

    def chunks(h, w):
        tiles = math.ceil(h / SR["tile"]) * math.ceil(w / SR["tile"])
        return math.ceil(tiles / SR["batch"])

    fused_leaky_relu.launches = 0
    int8_conv3x3_requant.launches = 0
    img = scene_image(768, 1024, seed=21)
    t0 = time.perf_counter()
    out = engine(img)
    dt = (time.perf_counter() - t0) * 1e3
    n = int8_conv3x3_requant.launches
    require(out.dtype == np.uint8 and out.shape == (3072, 4096, 3),
            f"EngineRestorer: {out.dtype} {out.shape}")
    require(n == K2_LAUNCHES_PER_CALL * chunks(768, 1024),
            f"EngineRestorer: K2 launched {n} times")
    log(f"EngineRestorer 1024x768 -> {out.shape[1]}x{out.shape[0]} uint8 in "
        f"{dt:.1f} ms (first call), {chunks(768, 1024)} engine chunk(s), "
        f"K2 launches {n}")
    expected = n
    core = ServiceCore(restorer, engine)
    server = make_server(core, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    req_ms = []
    try:
        bgr = np.ascontiguousarray(scene_image(360, 640, seed=22)[..., ::-1])
        ok, buf = cv2.imencode(".png", bgr)
        require(ok, "PNG encode")
        for i in range(2):
            before = int8_conv3x3_requant.launches
            t0 = time.perf_counter()
            status, media, body = post(port, "/SRx4/", buf.tobytes())
            req_ms.append((time.perf_counter() - t0) * 1e3)
            got = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            require(status == 200 and media == "image/png",
                    f"/SRx4/: {status} {media}")
            require(got is not None and got.shape == (1440, 2560, 3),
                    f"/SRx4/: decoded {None if got is None else got.shape}")
            n = int8_conv3x3_requant.launches - before
            require(n == K2_LAUNCHES_PER_CALL * chunks(360, 640),
                    f"/SRx4/: K2 launched {n} times")
            expected += n
            log(f"POST /SRx4/ 640x360 png -> 200 image/png 2560x1440  "
                f"{req_ms[-1]:.1f} ms, K2 launches {n}")
        t0 = time.perf_counter()
        direct = engine(np.ascontiguousarray(bgr[..., ::-1]))[..., ::-1]
        t1 = time.perf_counter()
        ok, _ = cv2.imencode(".png", np.ascontiguousarray(direct))
        t2 = time.perf_counter()
        expected += K2_LAUNCHES_PER_CALL * chunks(360, 640)
        require(np.array_equal(got, direct),
                "/SRx4/ answer differs from the engine's own output")
        log(f"/SRx4/ 640x360 split: EngineRestorer {(t1 - t0) * 1e3:.1f} ms, "
            f"PNG encode of the 2560x1440 answer {(t2 - t1) * 1e3:.1f} ms")
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    launches = int8_conv3x3_requant.launches
    require(launches == expected, f"K2 count {launches} != {expected}")
    require(fused_leaky_relu.launches == 0,
            f"K1 launched {fused_leaky_relu.launches} times on the SR path")
    log(f"SR main path: K2 launches {launches} "
        f"({K2_LAUNCHES_PER_CALL} per engine chunk), K1 launches 0")
    return launches, req_ms


def span_psnr(ref, got):
    ref, got = ref.float(), got.float()
    mse = ((ref - got) ** 2).mean().item()
    span = (ref.max() - ref.min()).item() or 1.0
    return 10 * math.log10(span ** 2 / max(mse, 1e-12))


def phase_sr_correctness():
    """TF32 off: chain on K2 vs chain on plain K2 (every layer), int8 vs
    packed bf16 (≥30 dB), tiled vs untiled float net, card vs CPU."""
    from unittest import mock as _mock
    from image_restoration_tpu_torch.infer import SR_MEAN_STD, SRVGG_X4
    from image_restoration_tpu_torch.infer import Restorer
    from image_restoration_tpu_torch.ops import int8_conv
    from image_restoration_tpu_torch.ops import quantized_inference as qi
    from image_restoration_tpu_torch.ops.packed_inference import (
        pack_srvgg_params, packed_srvgg_forward)
    from image_restoration_tpu_torch.parallel.tiling import tiled_apply
    from image_restoration_tpu_torch.serve.sr_engine import build_srvgg

    nc, up = SR["num_conv"], SR["upscale"]
    res = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = build_srvgg(SR["num_feat"], nc, up, seed=0, device="cuda")
        calib = torch.from_numpy(sr_calib()).cuda()
        scales = qi.calibrate_srvgg_act_scales(net, calib)
        net_cpu = build_srvgg(SR["num_feat"], nc, up, seed=0, device="cpu")
        cs = qi.calibrate_srvgg_act_scales(net_cpu, calib[:1, :64, :64].cpu())
        gs = qi.calibrate_srvgg_act_scales(net, calib[:1, :64, :64])
        rel = ((gs.cpu() - cs).abs() / cs).max().item()
        # tolerance: f32 convs sum in another order on each device, over
        # 34 layers
        log(f"calibration maxima, card vs CPU on one 64² crop (TF32 off): "
            f"max rel |d| {rel:.3g} (tolerance 1e-4)")
        require(rel <= 1e-4, f"calibration card vs CPU: {rel}")
        q = qi.quantize_srvgg_params(net, scales.tolist(), pack=2)
        log("calibration scales: " + " ".join(f"{v:.4g}" for v in
                                               scales.tolist()))

        s = SR["tile"] + 2 * SR["halo"]
        big = scene_image(2 * s, 4 * s, seed=23)
        tiles = np.stack([big[i * s:(i + 1) * s, j * s:(j + 1) * s]
                          for i in range(2) for j in range(4)])
        x = (torch.from_numpy(tiles).cuda().to(torch.bfloat16) / 255.0)

        acts = []
        real = int8_conv.int8_conv3x3_requant

        def record(*a, **k):
            out = real(*a, **k)
            acts.append(out)
            return out

        with _mock.patch.object(qi, "int8_conv3x3_requant", record):
            got = qi.quantized_srvgg_forward(q, x, nc, up, pack=2)
        torch.cuda.synchronize()
        require(len(acts) == K2_LAUNCHES_PER_CALL, f"{len(acts)} K2 calls")
        layer = iter(range(len(acts)))
        worst = 0

        def compare(*a, **k):
            out = int8_conv.int8_conv3x3_requant_plain(*a, **k)
            i = next(layer)
            d = (out.int() - acts[i].int()).abs().max().item()
            nonlocal worst
            worst = max(worst, d)
            require(d == 0, f"chain layer {i}: K2 vs plain max|d| {d}")
            acts[i] = None
            return out

        with _mock.patch.object(qi, "int8_conv3x3_requant", compare):
            want = qi.quantized_srvgg_forward(q, x, nc, up, pack=2)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "chain output: K2 vs plain differ")
        log(f"int8 chain on K2 vs on plain K2 (8 tiles of {s}², TF32 off): "
            f"{len(acts)} int8 activations equal (max|d| {worst}), bf16 "
            "output bit-equal")
        res["chain_k2_vs_plain_max_abs"] = worst
        del acts

        packed = pack_srvgg_params(net)
        ref = packed_srvgg_forward(packed, x, nc, up)
        db = span_psnr(ref, got)
        log(f"int8 vs packed bf16 at {s}² (8 synthetic-scene tiles): "
            f"span-normalized PSNR {db:.2f} dB (gate >= {SR_GATE_DB})")
        require(db >= SR_GATE_DB, f"int8 vs bf16 {db:.2f} dB")
        res["int8_vs_bf16_db"] = db
        del ref, packed

        sr = Restorer(SRVGG_X4, device="cuda", seed=0, **SR_MEAN_STD)
        img = torch.from_numpy(scene_image(300, 400, seed=24)).cuda()
        xf = img[None].float() / 255.0
        untiled = sr._fwd(xf)[0]
        halo = RECEPTIVE_RADIUS + 6
        tiled = tiled_apply(sr._fwd, xf, tile=128, halo=halo, scale=up,
                            tile_batch=4)[0]
        b = RECEPTIVE_RADIUS * up
        d = (tiled[b:-b, b:-b] - untiled[b:-b, b:-b]).abs().max().item()
        span = (untiled.max() - untiled.min()).item()
        # tolerance: cuDNN may pick another f32 algorithm (summation order)
        # for the tile shape than for the whole image
        log(f"float net tiled (tile 128, halo {halo}) vs untiled, 400x300, "
            f"interior ({b} px from the border): max|d| {d:.3g} over a span "
            f"of {span:.3g} (tolerance 1e-4 of the span)")
        require(d <= 1e-4 * max(1.0, span), f"tiled vs untiled: {d}")
        res["tiled_vs_untiled_max_abs"] = d
        del sr, untiled, tiled

        pair = x[:2, :64, :64].contiguous()
        q_cpu = {k: v.cpu() for k, v in q.items()}
        cpu = qi.quantized_srvgg_forward(q_cpu, pair.cpu(), nc, up, pack=2)
        card = qi.quantized_srvgg_forward(q, pair, nc, up, pack=2)
        dc = (card.cpu().float() - cpu.float()).abs().max().item()
        log(f"int8 chain, card vs CPU (two 64² tiles, full width and depth): "
            f"max|d| {dc}")
        require(dc == 0, f"card vs CPU: {dc}")
        res["card_vs_cpu_max_abs"] = dc
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.cuda.empty_cache()
    return res


def median_ms(fn, iters):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def phase_sr_throughput(engine_int8, engine_bf16):
    log(f"timed runs: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        "(PyTorch default)")
    s = SR["tile"] + 2 * SR["halo"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randint(0, 256, (SR["batch"], s, s, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)
    img = scene_image(768, 1024, seed=21)
    out = {}
    for mode, eng in (("int8", engine_int8), ("bf16", engine_bf16)):
        med, lo, hi = median_ms(lambda: eng.serve(x), 10)
        e2e, e_lo, e_hi = median_ms(lambda: eng(img), 3)
        out[mode] = dict(ms_per_call=med, ms_min=lo, ms_max=hi,
                         tiles_per_s=SR["batch"] / med * 1e3,
                         image_1024x768_ms=e2e)
        log(f"SR engine {mode}: {med:.3f} ms per call of {SR['batch']} "
            f"tiles (min {lo:.3f}, max {hi:.3f}) = "
            f"{out[mode]['tiles_per_s']:.2f} tiles/s (512² in, 2048² out); "
            f"EngineRestorer 1024x768: {e2e:.2f} ms (min {e_lo:.2f})")
    torch.cuda.reset_peak_memory_stats()
    engine_int8.serve(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"peak device memory, one int8 engine call: {peak:.1f} MiB")

    out["peak_mib"] = peak
    for mode, eng in (("int8", engine_int8), ("bf16", engine_bf16)):
        want = K2_LAUNCHES_PER_CALL if mode == "int8" else 0
        wall, kernels, k2_n = profile_call(lambda: eng.serve(x),
                                           "int8_conv3x3", want)
        busy = sum(k[0] for k in kernels)
        k2_ms = sum(k[0] for k in kernels if "int8_conv3x3" in k[2])
        log(f"profile of one {mode} engine call: wall {wall:.3f} ms, device "
            f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%), K2 {k2_ms:.3f} "
            f"ms over {k2_n} launches")
        for t, n, name in kernels[:12]:
            log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
        require(k2_n == want, f"profiler saw {k2_n} K2 launches ({mode})")
        out[f"profile_{mode}"] = dict(
            wall_ms=wall, busy_ms=busy, k2_device_ms=k2_ms,
            top=[dict(ms=t, count=n, name=name[:200])
                 for t, n, name in kernels[:20]])
    return out


# ------------------------------------------------------ path 3: ESRGAN ×4

RRDB_SIZE = 528             # the served tile, 512 + 2·8 halo (bench_rrdb.py)
RRDB_GATE_DB = 30.0         # int8 vs the float32 forward, at 2 blocks
RRDB_STAGES = [(64, 192), (32, 160), (32, 128), (32, 96), (32, 64)]
K2_STAGE_LAUNCHES = 15      # per RRDB block: 3 dense blocks × 5 stages


def k3_bound_ms(n, h, w, cin, cout):
    """Least time for one launch, bf16 in and out: x (pre-padded), the
    weights and out once over the memory rate, or 2·MACs over the bf16
    tensor-core peak, the larger."""
    ops = 2 * n * h * w * cout * 9 * cin
    nbytes = 2 * (n * (h + 2) * (w + 2) * cin + 9 * cin * cout
                  + n * h * w * cout)
    t_ops, t_bytes = ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_k3_kernels():
    """K3 against its plain version at the probe's five stage shapes at
    528² and a ragged shape; device times, bound, cuDNN; then the probe."""
    import torch.nn.functional as F
    from image_restoration_tpu_torch.ops.im2col_conv import (
        conv3x3_im2col, conv3x3_im2col_plain)
    from image_restoration_tpu_torch.scripts import probe_conv
    gen = torch.Generator(device="cuda").manual_seed(3)
    s = RRDB_SIZE
    log("K3 vs plain, tolerance: float32 out max|d| <= 1e-5 * max|plain|; "
        "bf16 out |d| <= 1 bf16 ulp of the plain value + 1e-5 * max|plain| "
        "(sums that cancel to near zero)")
    rows, worst = [], 0.0
    cases = [(1, s, s, cin, cout, 4 if cin == 64 else 8)
             for cin, cout in RRDB_STAGES] + [(2, 37, 45, 24, 36, 1)]
    for n, h, w, cin, cout, bh in cases:
        x = torch.randn((n, h + 2, w + 2, cin), generator=gen,
                        device="cuda").bfloat16()
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
              * 0.05).bfloat16()
        for out_dtype in (torch.float32, torch.bfloat16):
            got = conv3x3_im2col(x, wt, bh=bh, out_dtype=out_dtype)
            want = conv3x3_im2col_plain(x, wt, bh=bh, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            tol = 1e-5 * want.abs().max().item()
            if out_dtype == torch.float32:
                ok = err.max().item() <= tol
            else:
                ok = bool((err <= bf16_ulp(want.float()) + tol).all())
                worst = max(worst, err.max().item())
            require(ok, f"K3 {(n, h, w, cin, cout)} {out_dtype}: max|d| "
                        f"{err.max().item()}")
            del got, want, err
        if h != s:
            continue
        bound, bound_by = k3_bound_ms(n, h, w, cin, cout)
        xc = x.permute(0, 3, 1, 2)
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row = dict(Cin=cin, Cout=cout, N=n, H=h, W=w, bound_ms=bound,
                   bound_by=bound_by,
                   ms=device_time_ms(
                       lambda t: conv3x3_im2col(t, wt, bh=bh), [(x,)], 40),
                   plain_ms=device_time_ms(
                       lambda t: conv3x3_im2col_plain(t, wt, bh=bh),
                       [(x,)], 5),
                   cudnn_bf16_ms=device_time_ms(
                       lambda t: F.conv2d(t, wc), [(xc,)], 40))
        rows.append(row)
        log(f"K3 {cin:3d}->{cout:3d} {s}²  ms={row['ms']:.5f}  "
            f"plain_ms={row['plain_ms']:.5f}  bound_ms={bound:.5f} "
            f"({bound_by}, {100 * bound / row['ms']:.1f}% of it)  "
            f"cudnn_bf16_ms={row['cudnn_bf16_ms']:.5f}  "
            f"TFLOP/s={2 * 9 * cin * cout * s * s / row['ms'] / 1e9:.1f}")
        del x, xc
    log("K3 ragged shape (2 images, 37x45, Cin 24 padded to 32, Cout 36, "
        "bh 1), both out dtypes: within tolerance")
    per_pass = {k: sum(r[k] for r in rows)
                for k in ("ms", "plain_ms", "bound_ms", "cudnn_bf16_ms")}
    log("K3 per pass over the five stages: "
        + "  ".join(f"{k}={v:.5f}" for k, v in per_pass.items())
        + f"  ({100 * per_pass['bound_ms'] / per_pass['ms']:.1f}% of the "
          "bound)")
    # a launch's fixed cost: 48 rows of 528 are 132 tiles of 8 x 24, one per
    # block (two at 64 -> 192, whose 132 blocks split into two slices)
    for row, (cin, cout) in zip(rows, RRDB_STAGES):
        x = torch.randn((1, 50, s + 2, cin), generator=gen,
                        device="cuda").bfloat16()
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
              * 0.05).bfloat16()
        row["ms_48x528"] = device_time_ms(
            lambda t: conv3x3_im2col(t, wt), [(x,)], 40)
    log("K3 at 48x528 (132 tiles), ms per stage: "
        + "  ".join(f"{r['ms_48x528']:.5f}" for r in rows))
    torch.cuda.empty_cache()

    conv3x3_im2col.launches = 0
    probe = probe_conv.main([])
    k3_launches = conv3x3_im2col.launches
    require(k3_launches > 0, "probe_conv.main launched K3 no time")
    log(f"probe_conv.main: K3 launches {k3_launches}")
    return rows, per_pass, worst, probe, k3_launches


def phase_k2_deq():
    """K2's bf16_deq epilogue against its plain version at the five RRDB
    stage shapes at 528² (SAME padding), for one image and for the ladder's
    batch of 4, and at ragged shapes: bit-equal; times for one image, with
    torch._int_mm on the im2col matrix as the yardstick."""
    import torch.nn.functional as F
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant, int8_conv3x3_requant_plain)
    gen = torch.Generator(device="cuda").manual_seed(4)
    s = RRDB_SIZE
    rows = []
    for st, (cin, cout) in enumerate(RRDB_STAGES):
        for n in (4, 1):  # the 1-image inputs stay for the timing below
            x, wt, deq, b, _ = k2_inputs(gen, n, s, s, cin, cout, "bf16_deq",
                                         False)
            bias = b if st == 0 else None  # only stage 0 adds the biases
            got = int8_conv3x3_requant(x, wt, deq, bias, epilogue="bf16_deq")
            want = int8_conv3x3_requant_plain(x, wt, deq, bias,
                                              epilogue="bf16_deq")
            torch.cuda.synchronize()
            require(got.dtype == torch.bfloat16 and torch.equal(got, want),
                    f"K2 bf16_deq N={n} {cin}->{cout}: max|d| "
                    f"{(got.float() - want.float()).abs().max().item()}")
            del got, want
        ops = 2 * s * s * cout * 9 * cin
        nbytes = s * s * (cin + 2 * cout) + cout * 9 * cin
        t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        row = dict(Cin=cin, Cout=cout, bias=bias is not None,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ms=device_time_ms(lambda t: int8_conv3x3_requant(
                       t, wt, deq, bias, epilogue="bf16_deq"), [(x,)], 20),
                   plain_ms=device_time_ms(
                       lambda t: int8_conv3x3_requant_plain(
                           t, wt, deq, bias, epilogue="bf16_deq"),
                       [(x,)], 3))
        # the yardstick: the contraction alone as one int8 matrix product
        a_mat = im2col(x, cin)
        b_mat = wt.reshape(cout, 9 * cin).t()
        acc = torch._int_mm(a_mat, b_mat)
        ref = F.conv2d(x.permute(0, 3, 1, 2).double(),
                       wt.permute(0, 3, 1, 2).double(), padding=1)
        require(torch.equal(acc.double(), ref.permute(0, 2, 3, 1)
                            .reshape(-1, cout)),
                f"_int_mm yardstick differs from the conv ({cin}->{cout})")
        del acc, ref
        row["int_mm_ms"] = device_time_ms(
            lambda t: torch._int_mm(t, b_mat), [(a_mat,)], 20)
        del a_mat
        rows.append(row)
        log(f"K2 bf16_deq {cin:3d}->{cout:3d} {s}²  ms={row['ms']:.4f}  "
            f"plain_ms={row['plain_ms']:.4f}  bound_ms={row['bound_ms']:.5f}"
            f" ({row['bound_by']})  int_mm_ms={row['int_mm_ms']:.4f}  "
            "bit-equal at N=1 and N=4")
        del x
    for n, h, w, cin, cout in [(2, 25, 528, 32, 160), (1, 1, 528, 64, 192),
                               (3, 64, 136, 32, 128), (1, 9, 30, 128, 192),
                               (2, 19, 37, 10, 36)]:
        x, wt, deq, b, _ = k2_inputs(gen, n, h, w, cin, cout, "bf16_deq",
                                     False)
        saturate(x, wt)
        for bias in (b, None):
            got = int8_conv3x3_requant(x, wt, deq, bias, epilogue="bf16_deq")
            want = int8_conv3x3_requant_plain(x, wt, deq, bias,
                                              epilogue="bf16_deq")
            torch.cuda.synchronize()
            require(torch.equal(got.view(torch.int16),
                                want.view(torch.int16)),
                    f"K2 bf16_deq ragged {(n, h, w, cin, cout)} "
                    f"bias={bias is not None}")
    log("K2 bf16_deq ragged shapes (528 wide with H 25 and 1, W 136 and 37, "
        "Cin 10/32/64/128, Cout 36/128/160/192, sums >= 2^22 in a corner, "
        "with and without bias): bit-equal, signed zeros included")
    per_fwd = {k: 3 * 23 * sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms", "int_mm_ms")}
    log("K2 bf16_deq per RRDBNet-23 forward of one 528² tile (345 launches): "
        + "  ".join(f"{k}={v:.3f}" for k, v in per_fwd.items()))
    torch.cuda.empty_cache()
    return rows, per_fwd


def _counts_zero():
    from image_restoration_tpu_torch.ops.fused_act import fused_leaky_relu
    from image_restoration_tpu_torch.ops.im2col_conv import conv3x3_im2col
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    kernels = (fused_leaky_relu, int8_conv3x3_requant, conv3x3_im2col)
    for k in kernels:
        k.launches = 0
    return kernels


def phase_rrdb_main_path():
    """Counts at 0; `infer --arch rrdbnet --tile 512` on a 1024×768 PNG and
    `restore_tiled_u8` on the same image (cuDNN convs: no kernel of the
    port launches); then card vs CPU at full width and depth."""
    import tempfile
    import cv2
    from image_restoration_tpu_torch import infer
    img = scene_image(768, 1024, seed=31)
    kernels = _counts_zero()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "street.png")
        cv2.imwrite(src, img[..., ::-1])
        t0 = time.perf_counter()
        infer.main(["--input", src, "--output", os.path.join(tmp, "out"),
                    "--arch", "rrdbnet", "--tile", "512"])
        cli_s = time.perf_counter() - t0
        out = cv2.imread(os.path.join(tmp, "out", "street_restored.png"))
    require(out is not None and out.shape == (3072, 4096, 3),
            f"--arch rrdbnet wrote {None if out is None else out.shape}")
    require(float(out.std()) > 1.0, "constant --arch rrdbnet output")
    log(f"infer --arch rrdbnet --tile 512, 1024x768 PNG -> 4096x3072 PNG in "
        f"{cli_s:.2f} s (first call: weights, cuDNN plans, PNG IO)")
    restorer = infer.Restorer(infer.RRDBNET_X4, device="cuda", seed=0,
                              **infer.SR_MEAN_STD)
    first = restorer.restore_tiled_u8(img, tile=512)
    med, lo, hi = median_ms(lambda: restorer.restore_tiled_u8(img, tile=512),
                            3)
    require(first.shape == (3072, 4096, 3) and first.dtype == np.uint8,
            f"restore_tiled_u8: {first.shape}")
    launches = [k.launches for k in kernels]
    log(f"Restorer(RRDBNET_X4).restore_tiled_u8 1024x768 (4 tiles of 544², "
        f"float32, TF32 on): median {med:.1f} ms (min {lo:.1f}, max "
        f"{hi:.1f}); launches K1/K2/K3 on this path: {launches}")

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        small = img[300:348, 400:464][None].copy()
        cpu = infer.Restorer(infer.RRDBNET_X4, device="cpu", seed=0,
                             **infer.SR_MEAN_STD)
        t0 = time.perf_counter()
        ref = cpu.restore_batch_u8(small)
        cpu_s = time.perf_counter() - t0
        gpu = restorer.restore_batch_u8(small)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    dc = np.abs(ref.astype(np.int16) - gpu.astype(np.int16))
    log(f"RRDBNet-23 card vs CPU, 64x48 -> 256x192 (TF32 off): uint8 max "
        f"{dc.max()} LSB, mean {dc.mean():.5f} (CPU {cpu_s:.1f} s)")
    require(dc.max() <= 1, f"RRDBNet card vs CPU: {dc.max()} LSB")
    del restorer
    torch.cuda.empty_cache()
    return dict(cli_s=cli_s, restore_tiled_u8_ms=med, card_vs_cpu_lsb=int(
        dc.max()), launches=launches)


def rrdb_calib(size=160):
    """Two crops of a seeded synthetic scene (bench_rrdb.py calibrates on
    two 160² tiles)."""
    img = scene_image(384, 512, seed=33).astype(np.float32) / 255.0
    return np.stack([img[20:20 + size, 40:40 + size],
                     img[200:200 + size, 300:300 + size]])


def phase_rrdb_ladder():
    """bench_rrdb.py's ladder at 528², RRDBNet-23: tiles/s, peak memory,
    and a profile of one int8 forward."""
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.infer import RRDBNET_X4
    from image_restoration_tpu_torch.ops import packed_inference as pk
    from image_restoration_tpu_torch.ops import rrdb_quant as rq
    from image_restoration_tpu_torch.ops import rrdb_widened as wd
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    s, nb = RRDB_SIZE, RRDBNET_X4["num_block"]
    net = build_network(dict(RRDBNET_X4, dtype="bf16"),
                        torch.Generator().manual_seed(0)).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(6)
    xs = {bs: torch.rand((bs, s, s, 3), generator=gen, device="cuda")
          for bs in (1, 2, 4)}
    q = rq.quantize_rrdb_params(net, rq.calibrate_rrdb_act_scales(
        net, torch.from_numpy(rrdb_calib()).cuda()))
    ladder = [
        ("plain-bf16", 1, net, None),
        ("packed-g4-bf16", 4, pk.pack_rrdbnet_params(net, g=4),
         lambda p, x: pk.packed_rrdbnet_forward(p, x, nb, 4, g=4)),
        ("widened-bf16", 1, wd.widen_rrdbnet_params(net, g=1),
         lambda p, x: wd.widened_rrdbnet_forward(p, x, nb)),
        ("widened-bf16", 4, None, None),
        ("widened-g2-bf16", 2, wd.widen_rrdbnet_params(net, g=2),
         lambda p, x: wd.widened_rrdbnet_forward(p, x, nb, g=2)),
        ("widened-g4-bf16", 4, wd.widen_rrdbnet_params(net, g=4),
         lambda p, x: wd.widened_rrdbnet_forward(p, x, nb, g=4)),
        ("widened-int8", 1, q, lambda p, x: rq.quantized_rrdb_forward(
            p, x, nb)),
        ("widened-int8", 4, None, None),
    ]
    rows, prev = [], None
    log(f"RRDBNet-23 x4 ladder at {s}² (random input; cudnn TF32 setting "
        "irrelevant: bf16 and int8)")
    for name, bs, params, fn in ladder:
        if params is None:
            params, fn = prev
        prev = (params, fn)
        x = xs[bs]

        @torch.inference_mode()
        def call():
            return net(x) if fn is None else fn(params, x)

        is_int8 = name.endswith("int8")
        if is_int8:
            int8_conv3x3_requant.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        require(out.shape == (bs, 4 * s, 4 * s, 3)
                and bool(torch.isfinite(out.float()).all()),
                f"{name} bs={bs}: {tuple(out.shape)}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        del out
        med, lo, hi = median_ms(call, 3 if is_int8 else 5)
        row = dict(mode=name, bs=bs, ms=med, ms_min=lo, ms_max=hi,
                   tiles_per_s=bs / med * 1e3, peak_mib=peak)
        if is_int8:
            calls = 1 + 2 + 3  # checked call, median_ms's warm-up and runs
            row["k2_launches"] = int8_conv3x3_requant.launches
            require(row["k2_launches"] == calls * K2_STAGE_LAUNCHES * nb,
                    f"{name} bs={bs}: K2 launched {row['k2_launches']} "
                    f"times in {calls} forwards")
        rows.append(row)
        log(f"RRDB-23 {name} bs={bs}: {med:.2f} ms (min {lo:.2f}, max "
            f"{hi:.2f}) -> {row['tiles_per_s']:.3f} tiles/s, peak "
            f"{peak:.1f} MiB" + (f", K2 launches {row['k2_launches']}"
                                 if is_int8 else ""))
    x = xs[1]
    rq.quantized_rrdb_forward(q, x, nb)
    torch.cuda.synchronize()
    wall, kernels, k2_n = profile_call(
        lambda: rq.quantized_rrdb_forward(q, x, nb), "int8_conv3x3",
        K2_STAGE_LAUNCHES * nb)
    busy = sum(k[0] for k in kernels)
    k2_ms = sum(k[0] for k in kernels if "int8_conv3x3" in k[2])
    log(f"profile of one int8 RRDB-23 forward (bs 1, {s}²): wall "
        f"{wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), K2 {k2_ms:.2f} ms over {k2_n} "
        f"launches ({100 * k2_ms / max(busy, 1e-9):.1f}% of device time)")
    for t, n, name in kernels[:10]:
        log(f"  {t:9.4f} ms  x{n:<4d} {name[:110]}")
    require(k2_n == K2_STAGE_LAUNCHES * nb, f"profiler saw {k2_n} K2 "
            "launches in one int8 forward")
    prof_row = dict(wall_ms=wall, busy_ms=busy, k2_device_ms=k2_ms,
                    k2_launches=k2_n, top=[dict(ms=t, count=n, name=name[:200])
                                           for t, n, name in kernels[:15]])
    del xs, ladder, prev
    torch.cuda.empty_cache()
    return rows, prof_row, net, q


def phase_rrdb_int8_check(net23, q23):
    """TF32 off. At 2 blocks: the chain on K2 against the chain on K2's
    plain version at 528² (stage inputs and outputs equal), and int8 against
    the float32 forward at 256² (≥30 dB). The 23-block PSNR is printed."""
    from unittest import mock as _mock
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.infer import RRDBNET_X4
    from image_restoration_tpu_torch.ops import int8_conv
    from image_restoration_tpu_torch.ops import rrdb_quant as rq
    res = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        net = build_network(dict(RRDBNET_X4, num_block=2),
                            torch.Generator().manual_seed(0)).cuda().eval()
        q = rq.quantize_rrdb_params(net, rq.calibrate_rrdb_act_scales(
            net, torch.from_numpy(rrdb_calib()).cuda()))
        s = RRDB_SIZE
        x = torch.from_numpy(scene_image(s, s, seed=34)).cuda().float() / 255
        x = x[None]
        seen = []
        real = int8_conv.int8_conv3x3_requant

        def record(t, *a, **k):
            out = real(t, *a, **k)
            seen.append((t, out))
            return out

        with _mock.patch.object(rq, "int8_conv3x3_requant", record):
            got = rq.quantized_rrdb_forward(q, x, 2)
        torch.cuda.synchronize()
        require(len(seen) == 2 * K2_STAGE_LAUNCHES, f"{len(seen)} K2 calls")
        stage = iter(range(len(seen)))

        def compare(t, *a, **k):
            i = next(stage)
            require(torch.equal(t, seen[i][0]), f"stage input {i} differs")
            out = int8_conv.int8_conv3x3_requant_plain(t, *a, **k)
            require(torch.equal(out, seen[i][1]),
                    f"stage {i}: K2 vs plain output differs")
            seen[i] = None
            return out

        with _mock.patch.object(rq, "int8_conv3x3_requant", compare):
            want = rq.quantized_rrdb_forward(q, x, 2)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "int8 RRDB output: K2 vs plain")
        log(f"int8 RRDB chain (2 blocks, {s}², TF32 off) on K2 vs on plain "
            "K2: 30 stage inputs and outputs equal, bf16 output bit-equal")
        del seen, got, want

        y = torch.from_numpy(scene_image(256, 256, seed=35)).cuda()
        y = y[None].float() / 255
        for name, nt, qq, nb in (("2 blocks", net, q, 2),
                                 ("23 blocks", net23, q23, 23)):
            dtype, nt.dtype = nt.dtype, None  # the float32 forward
            try:
                with torch.no_grad():
                    ref = nt(y)
            finally:
                nt.dtype = dtype
            db = span_psnr(ref, rq.quantized_rrdb_forward(qq, y, nb))
            log(f"int8 RRDB ({name}) vs the float32 forward, 256² synthetic "
                f"scene: span-normalized PSNR {db:.2f} dB"
                + (f" (gate >= {RRDB_GATE_DB})" if nb == 2 else
                   " (no gate)"))
            res[f"int8_vs_f32_db_{nb}"] = db
        require(res["int8_vs_f32_db_2"] >= RRDB_GATE_DB,
                f"int8 RRDB vs f32: {res['int8_vs_f32_db_2']:.2f} dB")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    torch.cuda.empty_cache()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report to this JSON file")
    args = ap.parse_args(argv)

    require(torch.cuda.is_available(), "no CUDA device")
    from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN, Restorer

    t_start = time.perf_counter()
    smi = phase_device()
    build = phase_build()

    restorer = Restorer(PRODUCTION_GFPGAN, device="cuda", seed=0)
    randomize_weights(restorer.net, seed=1)
    imgs = np.stack([plate_image(256, 256, seed=i)[..., ::-1]
                     for i in range(16)])
    batches = {1: imgs[:1].copy(), 4: imgs[:4].copy(), 16: imgs.copy()}

    shapes = record_k1_shapes(restorer, batches[1])
    require(len(shapes) == K1_LAUNCHES_PER_FORWARD,
            f"{len(shapes)} K1 calls per forward")
    rows, agg, worst = phase_kernels(shapes)
    launches, req_ms = phase_main_path(restorer, batches)
    lsb, dfloat, cpu_lsb = phase_correctness(restorer, batches[4], batches[1])
    thr, peak = phase_throughput(restorer, batches)
    prof = phase_profile(restorer, batches[16])

    k2_rows, k2_call = phase_k2_kernels()
    engine = build_sr(int8=True)
    log(f"SR engine: {engine.meta}")
    k2_launches, sr_req_ms = phase_sr_main_path(restorer, engine)
    sr_check = phase_sr_correctness()
    sr_thr = phase_sr_throughput(engine, build_sr(int8=False))
    sr_meta = engine.meta
    del engine
    torch.cuda.empty_cache()

    k3_rows, k3_pass, k3_err, probe, k3_launches = phase_k3_kernels()
    deq_rows, deq_fwd = phase_k2_deq()
    rrdb_main = phase_rrdb_main_path()
    ladder, rrdb_prof, net23, q23 = phase_rrdb_ladder()
    rrdb_check = phase_rrdb_int8_check(net23, q23)
    del net23, q23

    a = agg[("float32", 16)]
    kernels = [{
        "name": "fused_bias_lrelu",
        "route": "cuda",
        "source": "image_restoration_tpu_torch/csrc/fused_bias_act.cu",
        "replaces": "image_restoration_tpu/ops/pallas/fused_act_kernel.py:43",
        "launches": launches,
        "max_abs_err": worst,
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "int8_conv3x3_requant",
        "route": "cuda",
        "source": "image_restoration_tpu_torch/csrc/int8_conv3x3.cu",
        "replaces": "image_restoration_tpu/ops/pallas/int8_conv.py:65",
        "launches": k2_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": k2_call["ms"],
        "plain_ms": k2_call["plain_ms"],
        "bound_ms": k2_call["bound_ms"],
        "bound_by": "operations",
        "library_ms": k2_call["int_mm_ms"],
    }, {
        "name": "conv3x3_im2col",
        "route": "cuda",
        "source": "image_restoration_tpu_torch/csrc/conv3x3_im2col.cu",
        "replaces": "image_restoration_tpu/ops/pallas/im2col_conv.py:76",
        "launches": k3_launches,
        "max_abs_err": k3_err,
        "ms": k3_pass["ms"],
        "plain_ms": k3_pass["plain_ms"],
        "bound_ms": k3_pass["bound_ms"],
        "bound_by": max(("bytes", "operations"), key=lambda b: sum(
            r["bound_ms"] for r in k3_rows if r["bound_by"] == b)),
        "library_ms": k3_pass["cudnn_bf16_ms"],
    }]
    report = dict(
        smi=smi, build_s=build, k1_rows=rows,
        k1_per_forward={f"{dt}_bs{bs}": v for (dt, bs), v in agg.items()},
        k1_device_ms_bs16_profiler=prof["k1_device_ms"],
        main_path_launches=launches, request_ms=req_ms,
        net_k1_vs_plain_lsb=lsb, net_k1_vs_plain_float=dfloat,
        card_vs_cpu_lsb=cpu_lsb, throughput=thr, peak_mib_bs16=peak,
        profile=prof, k2_rows=k2_rows, k2_per_engine_call=k2_call,
        sr_engine=sr_meta, sr_main_path_launches=k2_launches,
        sr_request_ms=sr_req_ms, sr_correctness=sr_check,
        sr_throughput=sr_thr, k3_rows=k3_rows, k3_per_pass=k3_pass,
        k3_probe=probe, k3_probe_launches=k3_launches,
        k2_bf16_deq_rows=deq_rows, k2_bf16_deq_per_rrdb23_forward=deq_fwd,
        rrdb_main_path=rrdb_main, rrdb_ladder=ladder, rrdb_profile=rrdb_prof,
        rrdb_int8=rrdb_check, seconds=time.perf_counter() - t_start,
        note="kernels[].ms/plain_ms/bound_ms: device time (calls back to "
             "back, CUDA events) and bound, summed over the 39 K1 launches "
             "of one batch-16 f32 forward, over the 34 K2 launches of "
             "one SR engine call (bf16 epilogue), and over K3's five "
             "launches of one pass over the widened stage shapes at 528² "
             "(bf16 out); K2's library_ms is torch._int_mm on the im2col "
             "matrix, the contraction alone (k2_bf16_deq_per_rrdb23_forward"
             " has the same yardstick for the RRDB half); K3's is cuDNN's "
             "bf16 conv; "
             "K3's launches are those of probe_conv.main()")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
