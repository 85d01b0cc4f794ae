"""The port's ×4 SR tile engine, `EngineRestorer` and `/SRx4/` against the JAX
package's exporter (`scripts/export_restorer.py` `build_engine`) and its
`EngineRestorer`: the same Real-ESRGAN `.pth` and the same calibration batch
go to both, at a small width and depth on the CPU. The int8 engine agrees bit
for bit; the packed bf16 engine to 2 LSB (bf16 convs accumulate in another
order in the two frameworks, and one bf16 ulp is 1 LSB in [0.5, 1), so
two flips reach 2 LSB)."""

import importlib.util
import json
import pathlib
import threading
import urllib.error
import urllib.request

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.parallel.tiling import tiled_apply as jax_tiled
from image_restoration_tpu.serve.engine_restorer import (
    EngineRestorer as JaxEngineRestorer)
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.serve.api import ServiceCore, make_server
from image_restoration_tpu_torch.serve.engine_restorer import EngineRestorer
from image_restoration_tpu_torch.serve.sr_engine import build_engine


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(num_feat=16, num_conv=3, upscale=4, tile=24, halo=4, batch=4)


def _jax_exporter():
    spec = importlib.util.spec_from_file_location(
        "export_restorer", REPO / "scripts" / "export_restorer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(port engine, JAX serve fn, JAX engine dir) for int8 and bf16, from
    one `.pth` with every parameter drawn from a seed."""
    tmp = tmp_path_factory.mktemp("sr_engine")
    net = build_network(dict(type="SRVGGNetCompact", num_feat=16, num_conv=3,
                             upscale=4), torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in net.state_dict().items()}
    # a small residual, as a trained net has: the output is the upsampled
    # input plus detail, not mostly clipped to 0 or 255
    sd["body.8.weight"] *= 0.02
    sd["body.8.bias"] *= 0.02
    pth = tmp / "srvgg.pth"
    torch.save({"params": sd}, pth)
    calib = np.random.default_rng(13).random((2, 40, 36, 3)).astype(
        np.float32)
    exporter = _jax_exporter()
    out = {}
    for mode, int8 in (("int8", True), ("bf16", False)):
        ser, meta, jserve = exporter.build_engine(
            pth=str(pth), int8=int8, calib=jnp.asarray(calib), io="u8",
            **SMALL)
        d = tmp / mode
        d.mkdir()
        (d / "engine.bin").write_bytes(ser)
        (d / "engine.json").write_text(json.dumps(meta))
        serve, tmeta = build_engine(pth=str(pth), int8=int8, calib=calib,
                                    device="cpu", **SMALL)
        for k in ("num_feat", "num_conv", "upscale", "tile", "halo", "batch",
                  "mode", "io", "input_shape", "input_dtype"):
            assert tmeta[k] == meta[k], k
        out[mode] = (serve, tmeta, jserve, str(d))
    return out


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.mark.parametrize("mode,lsb", [("int8", 0), ("bf16", 2)])
def test_engine_serve_matches_jax(engines, rng, mode, lsb):
    serve, meta, jserve, _ = engines[mode]
    x = (rng.random(meta["input_shape"]) * 255).astype(np.uint8)
    got = serve(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    assert got.shape == (4, 128, 128, 3)
    assert _lsb(got.numpy(), np.asarray(jserve(jnp.asarray(x)))) <= lsb


@pytest.mark.parametrize("mode,lsb", [("int8", 0), ("bf16", 2)])
def test_engine_restorer_matches_jax(engines, rng, mode, lsb):
    """An image of 3×2 tiles (one chunk of 4 and one zero-padded), through
    the port's EngineRestorer, the JAX tiler over the JAX engine's function,
    and the JAX EngineRestorer over the exported engine."""
    serve, meta, jserve, engine_dir = engines[mode]
    er = EngineRestorer(serve, meta)
    img = (rng.random((60, 41, 3)) * 255).astype(np.uint8)
    got = er(img)
    assert got.shape == (240, 164, 3) and got.dtype == np.uint8
    assert np.isin(got, (0, 255)).mean() < 0.05
    want = np.asarray(jax_tiled(jserve, jnp.asarray(img)[None], tile=24,
                                halo=4, scale=4, tile_batch=4)[0])
    assert _lsb(got, want) <= lsb
    # the deserialized engine is another XLA compilation of the same graph;
    # for the int8 chain its bf16 epilogues may round differently
    exported = JaxEngineRestorer(engine_dir)(img)
    assert _lsb(got, exported) <= 1
    # float [0, 1] input is quantized to uint8 first, as in JAX
    assert _lsb(er(img.astype(np.float32) / 255.0), got) == 0


def _post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=body,
        headers={"Content-Type": "application/octet-stream"})
    return urllib.request.urlopen(req, timeout=120)


def test_http_srx4(engines, rng):
    """POST an image to /SRx4/ on the stdlib server: 200, a PNG of 4× the
    size, equal to the engine's own output."""
    serve, meta, _, _ = engines["int8"]
    er = EngineRestorer(serve, meta)
    core = ServiceCore(None, er)
    server = make_server(core)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        img = (rng.random((30, 50, 3)) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".png", img)
        with _post(port, "/SRx4/", buf.tobytes()) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "image/png"
            out = cv2.imdecode(np.frombuffer(resp.read(), np.uint8),
                               cv2.IMREAD_COLOR)
        assert out.shape == (120, 200, 3)
        want = er(np.ascontiguousarray(img[..., ::-1]))[..., ::-1]
        np.testing.assert_array_equal(out, want)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/SRx4/", b"not an image")
        assert e.value.code == 500
    finally:
        server.shutdown()
        server.server_close()
        core.close()
        t.join(timeout=10)
    assert not t.is_alive()
