"""Port Restorer and restore server against the JAX package, plus the
port's isolation from JAX: the same weights (flax params through
`state_dict_from_jax`) and the same uint8/float images go to both
Restorers; outputs agree to ≤1 LSB."""

import ast
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch

from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu_torch import infer as tinfer
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.infer import Restorer
from image_restoration_tpu_torch.serve.api import ServiceCore, make_server


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
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_PKG = REPO / "image_restoration_tpu_torch"


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.fixture(scope="module")
def restorers():
    rng = np.random.default_rng(3)
    jr = JaxRestorer(TINY_GFPGAN)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jr.variables["params"])
    jr.variables = {"params": params}
    tr = Restorer(TINY_GFPGAN, device="cpu")
    tr.net.load_state_dict(state_dict_from_jax(tr.net, params), strict=True)
    return jr, tr


def test_restore_batch_matches_jax(restorers, rng):
    jr, tr = restorers
    imgs = rng.random((3, 64, 64, 3)).astype(np.float32)
    assert _lsb(tr.restore_batch(imgs), jr.restore_batch(imgs)) <= 1


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_restore_batch_u8_matches_jax(restorers, rng, hw):
    """(48, 80) is resized to the model's 64² on the device, in both."""
    jr, tr = restorers
    u8 = (rng.random((2, *hw, 3)) * 255).astype(np.uint8)
    got = tr.restore_batch_u8(u8)
    assert got.shape == (2, 64, 64, 3)
    assert _lsb(got, jr.restore_batch_u8(u8)) <= 1
    # and the port's u8 path against its own float path
    assert _lsb(got, tr.restore_batch(u8.astype(np.float32) / 255.0)) <= 1


def test_call_matches_jax(restorers, rng):
    jr, tr = restorers
    img = rng.random((40, 72, 3)).astype(np.float32)
    got = tr(img)
    assert got.shape == (64, 64, 3)
    assert _lsb(got, jr(img)) <= 1


def test_restorer_loads_reference_pth(restorers, rng, tmp_path):
    """A reference-style checkpoint ({'params_ema': state_dict}, with the
    fixed noise buffers and a `module.` prefix) loads into the port's
    Restorer; the noise buffers are dropped as the JAX importer drops
    them."""
    jr, tr = restorers
    sd = {f"module.{k}": v.clone() for k, v in tr.net.state_dict().items()}
    for i, s in enumerate(tr.net.stylegan_decoder.noise_shapes()):
        sd[f"module.stylegan_decoder.noises.noise{i}"] = torch.randn(
            s[0], s[3], s[1], s[2])
    path = tmp_path / "net_g.pth"
    torch.save({"params_ema": sd, "params": {}}, path)
    loaded = Restorer(TINY_GFPGAN, ckpt_path=str(path), device="cpu")
    u8 = (rng.random((1, 64, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(loaded.restore_batch_u8(u8),
                                  tr.restore_batch_u8(u8))


def test_img_util_matches_jax(rng, tmp_path):
    from image_restoration_tpu.utils import img_util as jiu
    from image_restoration_tpu_torch.utils import img_util as tiu
    x = rng.random((1, 9, 7, 3)).astype(np.float32) * 2.4 - 1.2
    np.testing.assert_array_equal(tiu.tensor2img(x, min_max=(-1, 1)),
                                  jiu.tensor2img(x, min_max=(-1, 1)))
    np.testing.assert_array_equal(
        tiu.tensor2img(torch.from_numpy(x), min_max=(-1, 1)),
        jiu.tensor2img(x, min_max=(-1, 1)))
    bgr = (rng.random((5, 6, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tiu.img2tensor(bgr), jiu.img2tensor(bgr))
    path = str(tmp_path / "a" / "img.png")
    tiu.imwrite(bgr, path)
    np.testing.assert_array_equal(tiu.imread(path), jiu.imread(path))


def test_service_core_host_io_matches_device_io(restorers, rng):
    """device_io=False (normalize on the host, float path) answers within
    1 LSB of the default device-IO path."""
    tr = restorers[1]
    rgb = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    dev, host = ServiceCore(tr), ServiceCore(tr, device_io=False)
    try:
        assert _lsb(dev._restore_one(dev._as_input(rgb)),
                    host._restore_one(host._as_input(rgb))) <= 1
    finally:
        dev.close()
        host.close()


def test_restore_batch_u8_rejects_float(restorers, rng):
    with pytest.raises(TypeError):
        restorers[1].restore_batch_u8(
            rng.random((1, 64, 64, 3)).astype(np.float32))


def test_restorer_device_defaults_to_cuda(monkeypatch):
    """No `device` means the GPU: without one the Restorer raises rather
    than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Restorer(TINY_GFPGAN)


@pytest.mark.parametrize("kwargs", [dict(data_parallel=2)])
def test_restorer_unported_modes_raise(kwargs):
    """data_parallel is ported (tests/test_torch_parallel.py serves over
    ["cpu", "cpu"]); asked for more CUDA devices than there are, it raises
    as JAX's raises above its local devices."""
    with pytest.raises(ValueError, match="local devices"):
        Restorer(TINY_GFPGAN, device="cpu", **kwargs)


def test_restorer_quant_modes(restorers, rng):
    """quant="dyn-int8" is ported (held against JAX in
    tests/test_torch_dyn_int8.py): it serves and departs from the float
    restorer at the same weights; an unknown mode raises ValueError, as in
    JAX."""
    with pytest.raises(ValueError, match="unknown quant mode"):
        Restorer(TINY_GFPGAN, quant="int4", device="cpu")
    q = Restorer(TINY_GFPGAN, quant="dyn-int8", device="cpu")
    q.net.load_state_dict(restorers[1].net.state_dict())
    u8 = (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    got, want = q.restore_batch_u8(u8), restorers[1].restore_batch_u8(u8)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert 0 < _lsb(got, want) and np.abs(
        got.astype(np.float32) - want.astype(np.float32)).mean() < 8.0


def test_cli_unported_arch_raises(tmp_path):
    """Every arch the CLI offers is ported (`--arch rrdbnet` runs: see
    `tests/test_torch_rrdbnet.py`); an arch it does not offer is refused by
    argparse before any file is read or written."""
    with pytest.raises(SystemExit):
        tinfer.main(["--input", str(tmp_path / "x.png"), "--output",
                     str(tmp_path / "out"), "--arch", "edsr", "--device",
                     "cpu"])
    assert not (tmp_path / "out").exists()


def _post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=body,
        headers={"Content-Type": "application/octet-stream"})
    return urllib.request.urlopen(req, timeout=120)


def test_http_restore_endpoints(restorers, rng):
    jr, tr = restorers
    core = ServiceCore(tr)
    server = make_server(core)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        img = (rng.random((50, 90, 3)) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".png", img)
        for route, shape in [("/Restore/", (64, 64, 3)),
                             ("/RestoreConcat/", (64, 128, 3))]:
            with _post(port, route, buf.tobytes()) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"] == "image/jpeg"
                out = cv2.imdecode(np.frombuffer(resp.read(), np.uint8),
                                   cv2.IMREAD_COLOR)
            assert out is not None and out.shape == shape
        # the restore itself is the Restorer's (before JPEG coding)
        small = cv2.resize(img, (64, 64))[..., ::-1]
        assert _lsb(core._restore_one(np.ascontiguousarray(small)),
                    jr.restore_batch_u8(small[None])[0]) <= 1
        for route, msg in [("/Vehicle_Resolution_GFPGAN/",
                            "no pipeline configured"),
                           ("/SRx4/", "no SR engine configured")]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, route, buf.tobytes())
            assert e.value.code == 500
            env = json.loads(e.value.read())
            assert env["is_success"] is False
            assert msg in env["results"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/Restore/", b"not an image")
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/Nope/", buf.tobytes())
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        t.join(timeout=10)
    assert not t.is_alive()


def _port_files():
    return sorted(PORT_PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax, optax or
    the JAX package."""
    banned = {"jax", "jaxlib", "flax", "optax", "image_restoration_tpu"}
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad


def test_port_imports_leave_jax_unloaded():
    """Importing every module of the port, in a fresh interpreter, loads
    neither jax nor image_restoration_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import image_restoration_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'image_restoration_tpu'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
