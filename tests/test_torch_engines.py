"""The port's exported serving engines on the CPU: `torch.export` artifacts
of the GFPGAN restorer (`scripts/export_gfpgan.py`, `EngineFaceRestorer`),
of the fused geometry graph (`--with-geometry`, `EngineGeoPipeline`,
`PlatePipeline(geo_engine=…)`), of the ×4 SR tile engine
(`scripts/export_restorer.py`, `EngineRestorer`, `IRT_SR_ENGINE`) and of the
detector (`scripts/export_detector.py`), mirroring the JAX package's
tests/test_engine_gfpgan.py, tests/test_serve_engine.py and
tests/test_export_restorer.py; the port's GFPGAN engine against the JAX
package's at the same weights; an artifact in a fresh interpreter without
jax; the device-type check; and `torch.library.opcheck` of the kernel
ops (K1, K2 and its RRDB stage op, K3). Every network's weights come from
flax through `convert/from_jax.py`."""

import json
import math
import shutil
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build_network
from image_restoration_tpu.detect.engine import PlateDetector as JaxDetector
from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu_torch.convert import (
    retinaface_state_dict_from_jax, state_dict_from_jax)
from image_restoration_tpu_torch.detect.engine import PlateDetector
from image_restoration_tpu_torch.ops.fused_act import fused_bias_lrelu_op
from image_restoration_tpu_torch.ops.im2col_conv import conv3x3_im2col_op
from image_restoration_tpu_torch.ops.int8_conv import (
    int8_conv3x3_requant_op, int8_conv3x3_rrdb_stage_op)
from image_restoration_tpu_torch.scripts import export_detector
from image_restoration_tpu_torch.scripts import export_gfpgan as tgf
from image_restoration_tpu_torch.scripts import export_restorer as tsr
from image_restoration_tpu_torch.serve import pipeline as tpl
from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
from image_restoration_tpu_torch.serve.engine_restorer import (
    EngineFaceRestorer, EngineGeoPipeline, EngineRestorer, save_engine)
from image_restoration_tpu_torch.serve.sr_engine import build_srvgg

REPO = Path(__file__).resolve().parent.parent
TINY_GFPGAN = dict(type="GFPGANv1OCR", input_width=64, input_height=64,
                   num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
                   input_is_latent=True, different_w=True, narrow=0.5,
                   sft_half=True)
SR_KW = dict(num_feat=16, num_conv=2, tile=32, halo=4, batch=2,
             device="cpu")
QUAD = np.array([[10, 22], [52, 18], [54, 44], [8, 47]], np.float32)


class TinyPipeline(tpl.PlatePipeline):
    TARGET = 64


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _u8(rng, shape):
    return (rng.random(shape) * 255).astype(np.uint8)



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One intra-op thread for this file's CPU work, so it loads the
    machine less while other test files run beside it; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """TINY_GFPGAN weights from flax (seeded init plus noise, as
    tests/test_torch_serve.py draws them) as a reference-layout `.pth`,
    which both packages' exporters import."""
    rng = np.random.default_rng(3)
    jr = JaxRestorer(TINY_GFPGAN)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jr.variables["params"])
    net = tgf.Restorer(TINY_GFPGAN, device="cpu").net
    path = tmp_path_factory.mktemp("weights") / "net_g.pth"
    torch.save({"params_ema": state_dict_from_jax(net, params)}, path)
    return str(path)


@pytest.fixture(scope="module")
def built(pth, tmp_path_factory):
    """(engine dir, live Restorer) of the batch-2 GFPGAN u8 engine."""
    program, meta, _, restorer = tgf.build_engine(
        net_opt=TINY_GFPGAN, pth=pth, batch=2, device="cpu")
    d = tmp_path_factory.mktemp("gfpgan_engine")
    save_engine(str(d), program, meta)
    return str(d), restorer


@pytest.fixture(scope="module")
def engine(built):
    """The GFPGAN artifact loaded once (a load takes seconds here)."""
    return EngineFaceRestorer(built[0], device="cpu")


@pytest.fixture(scope="module")
def sr_pth(tmp_path_factory):
    """SRVGGNetCompact (16 features, 2 convs) weights from flax (seeded init
    plus noise) as a Real-ESRGAN-layout `.pth`."""
    rng = np.random.default_rng(4)
    jnet = jax_build_network(dict(type="SRVGGNetCompact", num_feat=16,
                                  num_conv=2, upscale=4))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32),
        jax.jit(jnet.init)(jax.random.PRNGKey(0),
                           np.zeros((1, 16, 16, 3), np.float32))["params"])
    net = build_srvgg(num_feat=16, num_conv=2, device="cpu")
    path = tmp_path_factory.mktemp("sr_weights") / "srvgg.pth"
    torch.save({"params": state_dict_from_jax(net, params)}, path)
    return str(path)


@pytest.fixture(scope="module")
def sr_dir(sr_pth, tmp_path_factory):
    program, meta, _ = tsr.build_engine(pth=sr_pth, **SR_KW)
    d = tmp_path_factory.mktemp("sr_engine")
    save_engine(str(d), program, meta)
    return str(d)


# ------------------------------------------------------------ GFPGAN engine

def test_engine_matches_live_restorer(built, engine, rng):
    engine_dir, restorer = built
    eng = engine
    assert eng.input_size == (64, 64) and eng.batch == 2
    assert json.loads((Path(engine_dir) / "engine.json").read_text())[
        "device"] == "cpu"
    u8 = _u8(rng, (2, 64, 64, 3))
    got = eng.restore_batch_u8(u8)
    assert _lsb(got, restorer.restore_batch_u8(u8)) <= 1
    assert _lsb(eng.restore_batch(u8 / 255.0), got) == 0
    assert _lsb(eng(u8[0] / 255.0), got[0]) == 0


def test_engine_matches_jax_engine(engine, pth, tmp_path, rng):
    """The port's artifact against the JAX package's (jax.export), both
    exported from the same `.pth`: within the port's restore tolerance."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from export_gfpgan import build_engine as jax_build_engine
    finally:
        sys.path.remove(str(REPO / "scripts"))
    from image_restoration_tpu.serve.engine_restorer import (
        EngineFaceRestorer as JaxEngineFaceRestorer)
    ser, meta, _ = jax_build_engine(net_opt=TINY_GFPGAN, pth=pth, batch=2)
    (tmp_path / "engine.bin").write_bytes(ser)
    (tmp_path / "engine.json").write_text(json.dumps(meta))
    u8 = _u8(rng, (3, 64, 64, 3))
    want = JaxEngineFaceRestorer(str(tmp_path)).restore_batch_u8(u8)
    assert _lsb(engine.restore_batch_u8(u8), want) <= 1


def test_engine_ragged_batch_chunking(engine, rng):
    eng = engine
    u8 = _u8(rng, (5, 64, 64, 3))  # 2 + 2 + 1 (padded)
    got = eng.restore_batch_u8(u8)
    assert got.shape == (5, 64, 64, 3)
    # each row equals its own restore (the padding rows are dropped)
    for i in range(5):
        np.testing.assert_array_equal(
            got[i], eng.restore_batch_u8(np.repeat(u8[i:i + 1], 2, 0))[0])
    with pytest.raises(TypeError):
        eng.restore_batch_u8(u8.astype(np.float32))


def test_full_pipeline_from_artifacts(engine, tmp_path, rng):
    """The reference's deployment (a TensorRT detector, TorchScript
    restorers; api_plate_oto.py:331-336) from the port's artifacts: the
    detector's `.pth` written by scripts/export_detector.py (which also
    checks its exported detect graph) and the GFPGAN engine."""
    kw = dict(backbone="Resnet18", image_size=64, score_threshold=0.0,
              keep_top_k=5)
    src = retinaface_state_dict_from_jax(
        PlateDetector(device="cpu", **kw).net, JaxDetector(**kw).variables)
    torch.save(src, tmp_path / "flax_retinaface.pth")
    det_dir = tmp_path / "det"
    export_detector.main(["--out", str(det_dir), "--image_size", "64",
                          "--batch", "2", "--device", "cpu", "--ckpt",
                          str(tmp_path / "flax_retinaface.pth")])
    meta = json.loads((det_dir / "engine.json").read_text())
    assert meta["input_shape"] == [2, 64, 64, 3] and meta["device"] == "cpu"
    det = PlateDetector(ckpt_path=str(det_dir / "detector.pth"),
                        device="cpu", **kw)
    got = det.net.state_dict()
    for k, v in src.items():
        assert torch.equal(got[k], v), k
    pipe = TinyPipeline(detector=det, plate_restorer=engine,
                        car_restorer=engine)
    assert pipe.device_io  # the engine has the u8 entry point
    img = _u8(rng, (96, 128, 3))
    res = pipe.process(img)
    assert res["montage"].shape == (64, 6 * 64, 3)
    assert res["pasted"].dtype == np.uint8
    # batched: the fused 2N restore goes through the engine's chunking
    batched = pipe.process_batch([img, img, img], chunk_size=2)
    assert len(batched) == 3
    np.testing.assert_array_equal(batched[0]["montage"], res["montage"])


def test_geometry_engine_matches_live_fused(built, pth, tmp_path, rng):
    """--with-geometry exports the fused post-detector graph; loaded by
    EngineGeoPipeline into PlatePipeline(geo_engine=…) it reproduces the
    live device-geometry pipeline at the same weights, builds no restorer
    of its own, and the two kinds of engine refuse each other's
    artifact."""
    program, meta, _, _ = tgf.build_engine(
        net_opt=TINY_GFPGAN, pth=pth, batch=2, with_geometry=True,
        device="cpu")
    assert meta["geometry"]
    save_engine(str(tmp_path), program, meta)
    geo = EngineGeoPipeline(str(tmp_path), device="cpu")
    assert geo.target == 64 and geo.batch == 2
    det = SimpleNamespace(image_size=64)  # _geo_batch runs no detection
    live = TinyPipeline(detector=det, plate_restorer=built[1],
                        car_restorer=built[1], device_geometry=True)
    served = TinyPipeline(detector=det, geo_engine=geo)
    assert served.device_geometry and served.plate_restorer is None
    canvas = _u8(rng, (64, 64, 3))
    want_m, want_k = live._geo_batch(canvas[None], QUAD[None])
    got_m, got_k = served._geo_batch(canvas[None], QUAD[None])
    assert _lsb(got_m, want_m) <= 1
    np.testing.assert_array_equal(got_k, want_k)
    # ragged: 3 canvases through the frozen batch-2 engine
    mont3, _ = served._geo_batch(np.repeat(canvas[None], 3, 0),
                                 np.repeat(QUAD[None], 3, 0))
    assert mont3.shape == (3, 64, 6 * 64, 3)
    assert _lsb(mont3[2], want_m[0]) <= 1
    with pytest.raises(ValueError, match="geometry"):
        EngineGeoPipeline(built[0], device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        EngineFaceRestorer(str(tmp_path), device="cpu")


def test_engine_slots_into_service_core(engine, rng):
    """ServiceCore serves /Restore/ from the artifact, micro-batching
    included."""
    core = ServiceCore(pipeline=SimpleNamespace(car_restorer=engine),
                       restorer=engine, microbatch=2)
    try:
        assert core.device_io
        payload = core.restore(_u8(rng, (48, 48, 3)))
        out = cv2.imdecode(np.frombuffer(payload, np.uint8),
                           cv2.IMREAD_COLOR)
        assert out.shape == (64, 64, 3)
    finally:
        core.close()


def test_engine_device_type_check(built, sr_dir, tmp_path):
    """An artifact loads only for the device type it was exported for; a
    meta file that lies about it is caught by the tensors' device."""
    with pytest.raises(ValueError, match="exported for cpu"):
        EngineFaceRestorer(built[0], device="meta")
    with pytest.raises(ValueError, match="exported for cpu"):
        EngineRestorer(sr_dir, device="meta")
    shutil.copytree(sr_dir, tmp_path / "e")
    meta = json.loads((tmp_path / "e" / "engine.json").read_text())
    meta["device"] = "meta"
    (tmp_path / "e" / "engine.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="holds tensors on"):
        EngineRestorer(str(tmp_path / "e"), device="meta")


def test_engine_runs_in_fresh_interpreter_without_jax(sr_dir, rng):
    """An artifact needs only the port: a fresh interpreter loads and runs
    the SR artifact and never imports jax."""
    img = _u8(rng, (20, 28, 3))
    want = EngineRestorer(sr_dir, device="cpu")(img)
    code = (
        "import sys, numpy as np\n"
        "from image_restoration_tpu_torch.serve.engine_restorer import "
        "EngineRestorer\n"
        f"img = np.frombuffer(bytes.fromhex('{img.tobytes().hex()}'), "
        "np.uint8).reshape(20, 28, 3)\n"
        f"out = EngineRestorer({sr_dir!r}, device='cpu')(img)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', "
        "'image_restoration_tpu.')) for m in sys.modules), 'jax imported'\n"
        "sys.stdout.write(out.tobytes().hex())\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = np.frombuffer(bytes.fromhex(r.stdout), np.uint8).reshape(
        want.shape)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- SR engine

def test_sr_engine_roundtrip_small(sr_pth):
    """The exported program equals the live graph bit for bit (the same
    kernels run both)."""
    program, meta, serve = tsr.build_engine(pth=sr_pth, **SR_KW)
    assert meta["input_shape"] == [2, 40, 40, 3]
    assert meta["io"] == "bf16" and meta["mode"] == "int8"
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 40, 40, 3)).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        got, want = program.module()(x), serve(x)
    assert got.shape == (2, 160, 160, 3)
    assert torch.equal(got, want)


def test_sr_engine_cli_writes_artifacts(sr_pth, tmp_path):
    out = tmp_path / "eng"
    r = subprocess.run(
        [sys.executable, "-m",
         "image_restoration_tpu_torch.scripts.export_restorer", "--out",
         str(out), "--tile", "32", "--halo", "4", "--batch", "2",
         "--num_conv", "2", "--num_feat", "16", "--pth", sr_pth,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "round trip" in r.stdout
    meta = json.loads((out / "engine.json").read_text())
    assert meta["tile"] == 32 and meta["mode"] == "int8"
    assert meta["device"] == "cpu" and meta["io"] == "bf16"
    assert (out / "engine.pt2").stat().st_size > 0


def test_engine_restorer_arbitrary_size(sr_dir, rng):
    eng = EngineRestorer(sr_dir, device="cpu")
    assert not eng.u8_io
    img_u8 = _u8(rng, (50, 70, 3))
    out = eng(img_u8.astype(np.float32) / 255.0)  # not tile-aligned
    assert out.shape == (200, 280, 3) and out.dtype == np.uint8
    # uint8 input is converted on the host to exactly the same floats
    np.testing.assert_array_equal(eng(img_u8), out)


def test_u8_io_engine_matches_bf16_io(sr_pth, tmp_path, rng):
    """A --u8-io artifact (the /255 and clip/round inside) against the
    bf16-IO artifact of the same weights, packed bf16 (int8=False) so only
    the IO rounding differs."""
    engines = {}
    for io in ("bf16", "u8"):
        program, meta, _ = tsr.build_engine(io=io, int8=False, pth=sr_pth,
                                            **SR_KW)
        save_engine(str(tmp_path / io), program, meta)
        engines[io] = EngineRestorer(str(tmp_path / io), device="cpu")
    assert engines["u8"].u8_io and not engines["bf16"].u8_io
    img = _u8(rng, (40, 56, 3))
    a, b = engines["bf16"](img), engines["u8"](img)
    assert a.shape == b.shape == (160, 224, 3)
    assert _lsb(a, b) <= 2


def test_srx4_http_through_env_engine(sr_dir, engine, rng, monkeypatch):
    """`IRT_SR_ENGINE` points ServiceCore at an artifact, on the device of
    its restorer; /SRx4/ answers over HTTP."""
    monkeypatch.setenv("IRT_SR_ENGINE", sr_dir)
    core = ServiceCore(restorer=engine)
    assert isinstance(core.sr_engine, EngineRestorer)
    server = make_server(core, "127.0.0.1", 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        ok, buf = cv2.imencode(".png", _u8(rng, (40, 40, 3)))
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/SRx4/", data=buf.tobytes(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            payload = resp.read()
        out = cv2.imdecode(np.frombuffer(payload, np.uint8),
                           cv2.IMREAD_COLOR)
        assert out.shape == (160, 160, 3)
    finally:
        server.shutdown()
        core.close()


# ------------------------------------------------------------------- ops

def _k2_args(epilogue):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 6, 7, 8), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (4, 3, 3, 8), dtype=torch.int8, generator=g)
    deq, b, a = (torch.rand(4, generator=g) for _ in range(3))
    return {"f32": (x, w, deq * 1e-3, b, a, 2.5, 1, "f32"),
            "bf16": (x, w, deq * 1e-3, b, None, None, 0, "bf16"),
            "bf16_deq": (x, w, deq, None, None, None, 1, "bf16_deq")}[
        epilogue]


def _rrdb_stage_args(variant):
    """K2's RRDB stage op on one dense block's shapes (P of 160 channels):
    stage 0 (writes P), stage 2 (reads and updates it), stage 4 with the
    block carry and the next input's scale."""
    g = torch.Generator().manual_seed(3)
    stage, cout = {"rrdb-0": (0, 192), "rrdb-2": (2, 128),
                   "rrdb-carry": (4, 64)}[variant]
    cin = 64 if stage == 0 else 32
    x = torch.randint(-127, 128, (1, 5, 6, cin), dtype=torch.int8,
                      generator=g)
    w = torch.randint(-127, 128, (cout, 3, 3, cin), dtype=torch.int8,
                      generator=g)
    deq = (torch.rand(cout, generator=g) * 1e-4).bfloat16()
    b = torch.randn(cout, generator=g).bfloat16() if stage == 0 else None
    p = torch.randn(1, 5, 6, 160, generator=g).bfloat16()
    t, body = (torch.randn(1, 5, 6, 64, generator=g).bfloat16()
               if stage == 4 else None for _ in range(2))
    rin = torch.tensor(2.0, dtype=torch.bfloat16) if stage == 4 else None
    return (x, w, deq, b, p, t, body, rin, stage)


def _k1_args(dtype, with_bias=True):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 8, generator=g).to(dtype)
    b = torch.randn(8, generator=g) if with_bias else None
    if dtype == torch.float64:
        x.requires_grad_()
        b = b.double().requires_grad_()
    return (x, b, 0.2, math.sqrt(2.0))


def _k3_args(dtype):
    g = torch.Generator().manual_seed(2)
    return (torch.randn(1, 10, 7, 16, generator=g).to(dtype),
            torch.randn(3, 3, 16, 8, generator=g).to(dtype), 8,
            torch.float32 if dtype == torch.float32 else torch.bfloat16)


@pytest.mark.parametrize("op,args", [
    (fused_bias_lrelu_op, "k1-f32"), (fused_bias_lrelu_op, "k1-bf16-nobias"),
    (fused_bias_lrelu_op, "k1-f64-grad"),
    (int8_conv3x3_requant_op, "f32"), (int8_conv3x3_requant_op, "bf16"),
    (int8_conv3x3_requant_op, "bf16_deq"),
    (conv3x3_im2col_op, "k3-f32"), (conv3x3_im2col_op, "k3-bf16"),
    (int8_conv3x3_rrdb_stage_op, "rrdb-0"),
    (int8_conv3x3_rrdb_stage_op, "rrdb-2"),
    (int8_conv3x3_rrdb_stage_op, "rrdb-carry")])
def test_opcheck(op, args):
    """Schema (the RRDB stage op mutates P and nothing else), fake impl,
    autograd registration and AOT dispatch of each kernel op on the CPU
    (K1 with grad: its registered backward)."""
    built_args = {
        "k1-f32": lambda: _k1_args(torch.float32),
        "k1-bf16-nobias": lambda: _k1_args(torch.bfloat16, False),
        "k1-f64-grad": lambda: _k1_args(torch.float64),
        "k3-f32": lambda: _k3_args(torch.float32),
        "k3-bf16": lambda: _k3_args(torch.bfloat16),
    }.get(args, lambda: (_rrdb_stage_args(args) if args.startswith("rrdb")
                         else _k2_args(args)))()
    torch.library.opcheck(op, built_args)
