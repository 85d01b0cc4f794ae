#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Drives the port's main path — GFPGANv1OCR at PRODUCTION_GFPGAN (256²) behind
`Restorer.restore_batch_u8` and the stdlib restore server — with random
weights made from a seed, and fails loudly if any phase fails:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every hand-written kernel of the path, from csrc/, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     every (M, C) shape the main path gives it (batch 1 and 16, plus a
     ragged and a scalar-path shape), f32 and bf16, with its device time
     (calls back to back), its plain version's, the least time the card
     could take, and both as the host issues them;
  4. main path: launch counts set to 0, then one restore at batch 1, 4 and
     16 and four HTTP requests to /Restore/ and /RestoreConcat/; K1 must
     launch exactly 39 times per forward;
  5. correctness: the net with K1 against the same net on K1's plain
     version (TF32 off, ≤1 LSB), and the card against the CPU on one image;
  6. throughput (imgs/s per batch, PyTorch's default TF32 settings) and a
     profiler breakdown of one batch-16 forward.

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
K1_LAUNCHES_PER_FORWARD = 39
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
    builds = _build.build_all(["fused_bias_act"])
    total = time.perf_counter() - t0
    for b in builds:
        log(f"build {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for ln in b.log.splitlines():
            if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln):
                log(f"  {ln.strip()}")
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
                ulp = torch.exp2(torch.floor(torch.log2(
                    want.float().abs().clamp_min(1e-30))) - 7)
                ok = bool((err <= ulp).all())
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
    from torch.profiler import ProfilerActivity, profile
    restorer.restore_batch_u8(u8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        restorer.restore_batch_u8(u8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _kernel_events(prof)
    busy = sum(k[0] for k in kernels)
    k1 = [k for k in kernels if "fused_bias_lrelu" in k[2]]
    k1_ms = sum(k[0] for k in k1)
    k1_n = sum(k[1] for k in k1)
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
    }]
    report = dict(
        smi=smi, build_s=build, k1_rows=rows,
        k1_per_forward={f"{dt}_bs{bs}": v for (dt, bs), v in agg.items()},
        k1_device_ms_bs16_profiler=prof["k1_device_ms"],
        main_path_launches=launches, request_ms=req_ms,
        net_k1_vs_plain_lsb=lsb, net_k1_vs_plain_float=dfloat,
        card_vs_cpu_lsb=cpu_lsb, throughput=thr, peak_mib_bs16=peak,
        profile=prof, seconds=time.perf_counter() - t_start,
        note="kernels[].ms/plain_ms/bound_ms: device time (calls back to "
             "back, CUDA events) and bound, summed over the 39 K1 launches "
             "of one batch-16 f32 forward")
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
