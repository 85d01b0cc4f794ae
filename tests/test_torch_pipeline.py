"""Port product pipeline against the JAX package on the CPU: `PlatePipeline`
(host and device geometry), `ServiceCore.vehicle_resolution` and its HTTP
route, the `MicroBatcher`, and the `run_pipeline` CLI.

A `TinyPipeline` (TARGET 64, a Resnet18 detector at 64², TINY_GFPGAN as
both restorers) is built twice with the same weights: the detector's from a
numpy seed through the JAX importer `load_torch_retinaface`, the restorer's
from flax through `state_dict_from_jax`."""

import threading
import time
import urllib.request
from types import SimpleNamespace

import cv2
import jax
import numpy as np
import pytest
import torch

from image_restoration_tpu.convert.retinaface_import import (
    load_torch_retinaface)
from image_restoration_tpu.detect.engine import PlateDetector as JaxDetector
from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu.serve import pipeline as jpl
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.detect.engine import PlateDetector
from image_restoration_tpu_torch.infer import Restorer
from image_restoration_tpu_torch.serve import pipeline as tpl
from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
from image_restoration_tpu_torch.serve.batching import MicroBatcher, calibrate

from test_torch_detect import seeded_state_dict


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_GFPGAN = dict(type="GFPGANv1OCR", input_width=64, input_height=64,
                   num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
                   input_is_latent=True, different_w=True, narrow=0.5,
                   sft_half=True)
QUAD = np.array([[10, 22], [52, 18], [54, 44], [8, 47]], np.int32)
DEGENERATE = [np.array([[16, 63], [63, 0], [63, 0], [0, 38]], np.float32),
              np.array([[16, 63], [16, 63], [63, 0], [0, 38]], np.float32)]
PANELS = ("input", "plate_restored", "car_restored", "crop_padded",
          "transform", "pasted", "montage", "crop")


class TinyPort(tpl.PlatePipeline):
    TARGET = 64


class TinyJax(jpl.PlatePipeline):
    TARGET = 64


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _img(seed, h=96, w=128):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def parts():
    """(port detector, port restorer, JAX detector, JAX restorer) with the
    same weights."""
    kw = dict(backbone="Resnet18", image_size=64, score_threshold=0.0,
              keep_top_k=5)
    tdet = PlateDetector(device="cpu", **kw)
    sd = seeded_state_dict(tdet.net, seed=5)
    tdet.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jdet = JaxDetector(**kw)
    jdet.variables = load_torch_retinaface(sd, jdet.variables)

    rng = np.random.default_rng(3)
    jr = JaxRestorer(TINY_GFPGAN)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jr.variables["params"])
    jr.variables = {"params": params}
    tr = Restorer(TINY_GFPGAN, device="cpu")
    tr.net.load_state_dict(state_dict_from_jax(tr.net, params), strict=True)
    return tdet, tr, jdet, jr


def _port(parts, **kw):
    return TinyPort(detector=parts[0], plate_restorer=parts[1],
                    car_restorer=parts[1], **kw)


def _jax(parts, **kw):
    return TinyJax(detector=parts[2], plate_restorer=parts[3],
                   car_restorer=parts[3], **kw)


@pytest.fixture
def pinned(monkeypatch):
    """The detector's quad pinned to a plate-like quad, as
    tests/test_serve.py pins it (random weights can emit degenerate quads)."""
    for cls in (TinyPort, TinyJax):
        monkeypatch.setattr(cls, "_detect_quad",
                            lambda self, im: (QUAD.copy(), 0.9, True))


@pytest.mark.parametrize("device_geometry", [False, True])
def test_pinned_quad_panels_match_jax(parts, pinned, device_geometry):
    """Every panel within 1 LSB of the JAX pipeline on the same path: the
    host path's cv2 stages are the same calls, the restores agree to
    ≤1 LSB; the device path's geometry and restores are float twins."""
    img = _img(10)
    got = _port(parts, device_geometry=device_geometry).process(img)
    want = _jax(parts, device_geometry=device_geometry).process(img)
    assert sorted(got) == sorted(want)
    assert got["montage"].shape == (64, 6 * 64, 3)
    np.testing.assert_array_equal(got["quad"], want["quad"])
    assert (got["score"], got["detected"]) == (want["score"], want["detected"])
    for k in PANELS:
        assert _lsb(got[k], want[k]) <= 1, k


def test_device_geometry_matches_host_path(parts, pinned):
    """The port's device path against its host path, with the thresholds of
    tests/test_serve.py: geometry panels within cv2's fixed-point rounding
    and the polygon-edge band, restored panels by mean drift."""
    img = _img(11)
    want = _port(parts).process(img)
    got = _port(parts, device_geometry=True).process(img)
    for key in ("crop", "crop_padded", "transform"):
        d = np.abs(got[key].astype(np.float32) - want[key].astype(np.float32))
        assert np.quantile(d, 0.90) <= 2.0 and d.mean() <= 8.0, key
    for key in ("plate_restored", "car_restored", "pasted"):
        d = np.abs(got[key].astype(np.float32) - want[key].astype(np.float32))
        assert d.mean() <= 12.0, key


def test_device_geometry_degenerate_quads(parts):
    """Both degenerate quads (non-finite and finite-but-singular
    homography) give finite uint8 panels and black warped content."""
    canvas = _img(12, 64, 64)
    pipe = _port(parts, device_geometry=True)
    for quad in DEGENERATE:
        mont, masked = pipe._geo_batch(canvas[None], quad[None])
        assert mont.dtype == np.uint8 and mont.shape == (1, 64, 384, 3)
        assert masked.shape == (1, 64, 64, 3)
        assert (mont[0][:, 4 * 64:5 * 64] > 0).mean() < 0.01


@pytest.mark.parametrize("device_geometry", [False, True])
def test_process_batch_matches_process(parts, device_geometry):
    """Five images in chunks of 2 (a ragged last chunk), host stages on 3
    threads, against `process` on each image: the host-computed fields
    equal; the restored panels within 1 LSB, since the restores run at
    another batch size (1 against 2·chunk), where the CPU's convs may sum
    in another order."""
    pipe = _port(parts, device_geometry=device_geometry)
    imgs = [_img(20 + i, 100 + 7 * i, 140) for i in range(5)]
    batched = pipe.process_batch(imgs, chunk_size=2, host_workers=3)
    assert len(batched) == len(imgs)
    for img, got in zip(imgs, batched):
        want = pipe.process(img)
        assert sorted(got) == sorted(want)
        assert (got["score"], got["detected"]) == (want["score"],
                                                   want["detected"])
        np.testing.assert_array_equal(got["quad"], want["quad"])
        for k in ("input", "crop", "crop_padded", "transform"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("plate_restored", "car_restored", "pasted", "montage"):
            assert _lsb(got[k], want[k]) <= 1, k


def test_unpinned_quad_matches_jax(parts):
    """The detector's own quad on a seeded image equals JAX's."""
    img = _img(13, 120, 160)
    got = _port(parts)._detect_quad(img)
    want = _jax(parts)._detect_quad(img)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=2e-4)


def test_auto_selects_geometry(parts):
    """device_geometry="auto": process() stays on the host path; the first
    process_batch times both paths and keeps the faster."""
    auto = _port(parts, device_geometry="auto")
    assert auto._geo_auto_pending and not auto.device_geometry
    img = _img(14)
    auto.process(img)
    assert auto._geo_auto_pending
    outs = auto.process_batch([img] * 2, chunk_size=2)
    assert len(outs) == 2 and not auto._geo_auto_pending
    ms = auto.geo_auto_ms_per_image
    assert set(ms) == {"host", "device"} and min(ms.values()) > 0
    assert auto.device_geometry == (ms["device"] <= ms["host"])
    for o in outs:
        assert o["montage"].shape == (64, 384, 3)


def test_pipeline_defaults_to_cuda_and_refuses_engine(parts, monkeypatch):
    """A geometry engine exported at another canvas size is refused (JAX
    `serve/pipeline.py:215-220`); the engines themselves are held in
    tests/test_torch_engines.py."""
    with pytest.raises(ValueError, match="target"):
        _port(parts, geo_engine=SimpleNamespace(target=32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.PlatePipeline()


def test_device_geometry_refuses_resizing_restorer(parts):
    big = SimpleNamespace(input_size=(256, 256), mean=0, std=1,
                          out_min_max=(-1, 1), device="cpu")
    with pytest.raises(ValueError, match="input_size"):
        tpl.build_geo_fused(big, big, 64)


def test_helpers_match_jax(rng):
    img = (rng.random((30, 60, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tpl.resize_with_padding(img, (64, 64)),
                                  jpl.resize_with_padding(img, (64, 64)))
    s = tpl.image_to_base64(img)
    assert s == jpl.image_to_base64(img)
    assert tpl.base64_to_image(s).shape == img.shape


def _post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=body,
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


@pytest.mark.parametrize("microbatch", [0, 4])
def test_vehicle_endpoint_over_http(parts, microbatch):
    """POST /Vehicle_Resolution_GFPGAN/: 200 and the (64, 384, 3) montage
    PNG of the pipeline's own call (`process`, or `process_batch` in
    chunks of 4 behind the micro-batcher); /Restore/ uses the car
    restorer."""
    pipe = _port(parts)
    core = ServiceCore(pipeline=pipe, microbatch=microbatch)
    assert core.restorer is parts[1]
    server = make_server(core)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        img = _img(15, 100, 100)
        ok, buf = cv2.imencode(".png", img)
        status, media, body = _post(port, "/Vehicle_Resolution_GFPGAN/",
                                    buf.tobytes())
        assert (status, media) == (200, "image/png")
        out = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
        assert out.shape == (64, 384, 3)
        direct = (pipe.process_batch([img], chunk_size=4)[0] if microbatch
                  else pipe.process(img))["montage"]
        np.testing.assert_array_equal(out, direct)
        if microbatch:
            assert core.pipeline_batcher.stats["items"] == 1
        status, media, _ = _post(port, "/Restore/", buf.tobytes())
        assert (status, media) == (200, "image/jpeg")
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_run_pipeline_cli(parts, tmp_path):
    from image_restoration_tpu_torch.scripts.run_pipeline import main
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        cv2.imwrite(str(src / f"im{i}.jpg"), _img(30 + i, 80, 120))
    out = tmp_path / "out"
    results = main(["--input", str(src / "*.jpg"), "--output", str(out),
                    "--chunk", "2", "--save", "montage,pasted"],
                   pipeline=_port(parts))
    assert len(results) == 3
    for i in range(3):
        assert cv2.imread(str(out / f"im{i}_montage.png")).shape == (64, 384,
                                                                     3)
        assert (out / f"im{i}_pasted.png").exists()
    with pytest.raises(SystemExit):
        main(["--input", str(src / "*.jpg"), "--save", "nope"],
             pipeline=_port(parts))


# ------------------------------------------------------------ MicroBatcher

def make_recorder(out_fn=lambda a: a * 2.0, delay_s=0.0):
    calls = []

    def batch_fn(arr):
        calls.append(arr.shape[0])
        if delay_s:
            time.sleep(delay_s)
        return out_fn(arr)

    return batch_fn, calls


def test_microbatcher_coalesces_and_routes():
    batch_fn, calls = make_recorder(delay_s=0.02)
    b = MicroBatcher(batch_fn, max_batch=8, max_wait_ms=100.0)
    items = [np.full((4, 4, 3), i, np.float32) for i in range(8)]
    outs = [f.result(timeout=10) for f in [b.submit(x) for x in items]]
    for i, o in enumerate(outs):  # each result back to its caller
        np.testing.assert_allclose(o, items[i] * 2.0)
    assert sum(calls) >= 8 and len(calls) < 8
    assert b.stats["items"] == 8
    b.stop()


def test_microbatcher_bucket_padding():
    batch_fn, calls = make_recorder()
    b = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=50.0,
                     buckets=(1, 2, 4))
    futs = [b.submit(np.ones((2, 2), np.float32) * i) for i in range(3)]
    assert len([f.result(timeout=10) for f in futs]) == 3
    assert all(c in (1, 2, 4) for c in calls)
    assert b.stats["padded_rows"] >= 1 or len(calls) > 1
    b.stop()


@pytest.mark.parametrize("stack", [True, False])
def test_microbatcher_exception_fans_out(stack):
    def boom(arr):
        raise RuntimeError("device on fire")

    b = MicroBatcher(boom, max_batch=4, max_wait_ms=20.0, stack=stack)
    futs = [b.submit(np.zeros((2,), np.float32)) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
    b.stop()


def test_microbatcher_shape_mismatch_rejected_at_submit():
    batch_fn, _ = make_recorder()
    b = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=20.0)
    b.submit(np.zeros((4, 4), np.float32)).result(timeout=10)
    with pytest.raises(ValueError, match="resize before submitting"):
        b.submit(np.zeros((8, 8), np.float32))
    b.stop()


def test_microbatcher_single_request_latency_bounded():
    batch_fn, calls = make_recorder()
    b = MicroBatcher(batch_fn, max_batch=32, max_wait_ms=30.0)
    t0 = time.monotonic()
    b(np.zeros((2, 2), np.float32), timeout=10)
    assert time.monotonic() - t0 < 5.0 and calls == [1]
    b.stop()


def test_microbatcher_list_mode():
    """stack=False hands the raw item list to batch_fn (the
    process_batch contract): no shape check, no padding; a wrong result
    count fails every caller of that call."""
    calls = []

    def list_fn(items):
        calls.append([i.shape for i in items])
        time.sleep(0.02)
        return [i.sum() for i in items]

    b = MicroBatcher(list_fn, max_batch=8, max_wait_ms=100.0, stack=False)
    items = [np.ones((4 + i, 3), np.float32) for i in range(6)]
    outs = [f.result(timeout=10) for f in [b.submit(x) for x in items]]
    for x, o in zip(items, outs):
        np.testing.assert_allclose(o, x.sum())
    assert sum(len(c) for c in calls) == 6 and len(calls) < 6
    assert b.stats["padded_rows"] == 0
    b.stop()

    b = MicroBatcher(lambda it: it[:-1] if len(it) > 1 else it, max_batch=4,
                     max_wait_ms=50.0, stack=False)
    for f in [b.submit(np.zeros(2, np.float32)) for _ in range(3)]:
        try:
            f.result(timeout=10)
        except RuntimeError as e:
            assert "results for" in str(e)
    b.stop()


def test_microbatcher_pipeline_overlaps_dispatches():
    """pipeline_depth=2: a second batch starts while the first is in
    flight."""
    started, lock = [], threading.Lock()

    def slow_fn(arr):
        with lock:
            started.append(time.monotonic())
        time.sleep(0.05)
        return arr * 2.0

    b = MicroBatcher(slow_fn, max_batch=2, max_wait_ms=5.0, pipeline_depth=2)
    items = [np.full((2, 2), i, np.float32) for i in range(4)]
    t0 = time.monotonic()
    outs = [f.result(timeout=10) for f in [b.submit(x) for x in items]]
    wall = time.monotonic() - t0
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, items[i] * 2.0)
    assert len(started) >= 2 and started[1] - started[0] < 0.045, started
    assert wall < 0.095, f"no overlap: {wall:.3f}s"
    b.stop()


def test_microbatcher_depth_one_serializes():
    active, peak, lock = [0], [0], threading.Lock()

    def fn(arr):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.02)
        with lock:
            active[0] -= 1
        return arr

    b = MicroBatcher(fn, max_batch=2, max_wait_ms=1.0, pipeline_depth=1)
    for f in [b.submit(np.zeros((2,), np.float32)) for _ in range(6)]:
        f.result(timeout=10)
    assert peak[0] == 1
    b.stop()


def test_microbatcher_min_fill_blocks_starved_dispatches():
    batch_fn, calls = make_recorder(delay_s=0.15)
    b = MicroBatcher(batch_fn, max_batch=8, max_wait_ms=100.0,
                     pipeline_depth=2, min_fill=4)
    first = [b.submit(np.full((2, 2), i, np.float32)) for i in range(8)]
    time.sleep(0.01)  # the first batch (size 8) is in flight
    trickle = []
    for i in range(4):  # one item every 10 ms while it round-trips
        trickle.append(b.submit(np.full((2, 2), 10 + i, np.float32)))
        time.sleep(0.01)
    for f in first + trickle:
        f.result(timeout=10)
    assert all(c >= 4 for c in calls), calls
    b.stop()


def test_microbatcher_cancelled_future_does_not_kill_dispatcher():
    batch_fn, _ = make_recorder(delay_s=0.05)
    b = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=1.0)
    b.submit(np.zeros((2, 2), np.float32)).cancel()
    for _ in range(3):
        out = b.submit(np.ones((2, 2), np.float32)).result(timeout=10)
        np.testing.assert_allclose(out, 2.0)
    assert b._thread.is_alive()
    b.stop()


@pytest.mark.parametrize("regime,recommend", [("overhead", True),
                                              ("per-item", False)])
def test_calibrate(regime, recommend):
    """A fixed per-call cost makes coalescing win; a pure per-item cost
    whose concurrent calls overlap cannot."""
    def overhead_fn(arr):
        time.sleep(0.03)
        return arr

    def item_fn(arr):
        time.sleep(0.002 * arr.shape[0])
        return arr

    d = calibrate(overhead_fn if regime == "overhead" else item_fn,
                  np.zeros((2, 2), np.float32), max_batch=16, concurrency=8,
                  repeats=2)
    assert d["recommend"] is recommend
    if recommend:
        assert d["batched_imgs_per_s"] > d["per_request_imgs_per_s"]


class _StubRestorer:
    """Restorer-shaped stub: RGB float [0,1] in, BGR uint8 out, taking
    cost(n) seconds for n images; records its batch sizes and the thread it
    ran on."""

    input_size = (16, 16)

    def __init__(self, cost=lambda n: 0.02):
        self.batch_sizes, self.threads = [], set()
        self.cost = cost

    def restore_batch(self, imgs):
        self.batch_sizes.append(imgs.shape[0])
        self.threads.add(threading.current_thread().name)
        time.sleep(self.cost(imgs.shape[0]))
        return (imgs[..., ::-1] * 255).astype(np.uint8)

    def __call__(self, img):
        return self.restore_batch(img[None])[0]


class _StubPipeline:
    """PlatePipeline-shaped stub recording process_batch coalescing."""

    def __init__(self, restorer):
        self.car_restorer = restorer
        self.batch_calls, self.threads = [], set()

    def process(self, img):  # pragma: no cover - the batcher is on
        raise AssertionError("per-image process called with batcher on")

    def process_batch(self, imgs, chunk_size=8):
        self.batch_calls.append(len(imgs))
        self.threads.add(threading.current_thread().name)
        time.sleep(0.02)
        return [{"montage": np.full((8, 48, 3), 7, np.uint8)} for _ in imgs]


@pytest.mark.parametrize("route", ["/Restore/", "/Vehicle_Resolution_GFPGAN/"])
def test_http_concurrent_requests_coalesce(route):
    """Concurrent requests share calls through the micro-batchers (list
    mode for the pipeline), and every call runs on the core's one restore
    thread."""
    stub = _StubRestorer()
    pipe = _StubPipeline(stub)
    core = ServiceCore(pipeline=pipe, restorer=stub, microbatch=8,
                       microbatch_wait_ms=100.0)
    server = make_server(core)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    n = 8 if route == "/Restore/" else 6
    try:
        img = (np.random.default_rng(0).random((20, 30, 3)) * 255)
        ok, buf = cv2.imencode(".jpg", img.astype(np.uint8))
        results, errs = [], []

        def post():
            try:
                results.append(_post(port, route, buf.tobytes())[2])
            except Exception as exc:  # pragma: no cover
                errs.append(exc)

        threads = [threading.Thread(target=post) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs and len(results) == n
        for r in results:
            out = cv2.imdecode(np.frombuffer(r, np.uint8), cv2.IMREAD_COLOR)
            if route == "/Restore/":
                assert out.shape == (16, 16, 3)
            else:
                assert out.shape == (8, 48, 3) and (out == 7).all()
        if route == "/Restore/":
            assert core.batcher.stats["items"] == n
            assert core.batcher.stats["dispatches"] < n
            assert stub.threads and all(t.startswith("restore")
                                        for t in stub.threads)
        else:
            assert sum(pipe.batch_calls) == n and len(pipe.batch_calls) < n
            assert all(t.startswith("restore") for t in pipe.threads)
    finally:
        server.shutdown()
        server.server_close()
        core.close()


@pytest.mark.parametrize("cost,on", [
    (lambda n: 0.005 + 0.001 * n, True), (lambda n: 0.004 * n * n, False)])
def test_service_core_auto_microbatch(monkeypatch, cost, on):
    """microbatch="auto" measures both regimes through the core's one
    restore thread and keeps the batchers only where coalescing wins: with
    a fixed cost per call it does; with a cost per image that grows with the
    batch it cannot (calls on the one thread never overlap, so per-request
    dispatch has nothing else to gain)."""
    monkeypatch.setenv("IRT_MICROBATCH_MAX", "8")
    s = _StubRestorer(cost)
    core = ServiceCore(pipeline=SimpleNamespace(car_restorer=s), restorer=s,
                       microbatch="auto")
    try:
        assert core.microbatch_decision["recommend"] is on
        assert (core.batcher is not None) is on
        assert (core.pipeline_batcher is not None) is on
        if on:
            assert core.batcher.max_batch == 8
    finally:
        core.close()
