"""Port RRDBNet, its weight conversion, the packed and widened forms, the
tiled Restorer and `--arch rrdbnet` against the JAX package: the same weights
(flax params through `state_dict_from_jax`) and the same numpy inputs go to
both. Float32 paths agree to 1e-5 of max|ref| or rtol 1e-4 / atol 1e-5 (the
JAX tests' tolerance; float32 summation order); bf16 paths to a stated
span-normalized PSNR; uint8 outputs to 1 LSB."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.torch_import import import_network
from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu.ops import packed_inference as jpacked
from image_restoration_tpu.ops import rrdb_widened as jwide
from image_restoration_tpu_torch import infer as tinfer
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.convert.pth import load_pth
from image_restoration_tpu_torch.ops import packed_inference as tpacked
from image_restoration_tpu_torch.ops import rrdb_widened as twide
from image_restoration_tpu_torch.parallel import tiling as ttiling


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(type="RRDBNet", num_feat=16, num_grow_ch=8, num_block=2, scale=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_rrdb(rng, opt, shape):
    """A flax RRDBNet with every parameter drawn from rng, biases too."""
    net = jax_build(opt)
    x = rng.random(shape).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    return net, params, x


def _port_net(opt, params):
    net = build_network(opt)
    net.load_state_dict(state_dict_from_jax(net, params), strict=True)
    return net.eval()


def _psnr(ref, got):
    mse = float(np.mean((ref - got) ** 2))
    span = float(ref.max() - ref.min()) or 1.0
    return 10 * np.log10(span ** 2 / max(mse, 1e-20))


@pytest.mark.parametrize("scale", [4, 2, 1])
def test_rrdbnet_matches_flax(rng, scale):
    """num_feat 32, grow 16, 2 blocks; the ×2 and ×1 heads pixel-unshuffle
    the input by 2 and 4."""
    opt = dict(type="RRDBNet", num_feat=32, num_grow_ch=16, num_block=2,
               scale=scale)
    jnet, params, x = _jax_rrdb(rng, opt, (4, 16, 12, 3))
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_net(opt, params)(_t(x)).numpy()
    assert got.shape == want.shape == (4, 16 * scale, 12 * scale, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_rrdbnet_bf16_dtype_matches_flax(rng):
    """dtype=bf16 runs every conv and activation in bf16, as flax's `dtype`
    does; the frameworks round at the same places, but sum each conv in
    another order: ≥ 40 dB span-normalized PSNR."""
    opt = dict(SMALL, dtype=jnp.bfloat16)
    jnet, params, x = _jax_rrdb(rng, opt, (2, 12, 10, 3))
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    with torch.no_grad():
        got = _port_net(dict(SMALL, dtype="bf16"), params)(_t(x))
    assert got.dtype == torch.bfloat16
    assert _psnr(want, got.float().numpy()) >= 40.0


def test_state_dict_from_jax_round_trip(rng):
    """The port's reference-layout state_dict → flax through the JAX
    importer → back through `state_dict_from_jax`: exact, key by key."""
    net = build_network(SMALL, torch.Generator().manual_seed(4))
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(i))
          for i, (k, v) in enumerate(net.state_dict().items())}
    assert "body.1.rdb3.conv5.weight" in sd and "conv_last.bias" in sd
    jnet, _, x = _jax_rrdb(rng, SMALL, (1, 8, 8, 3))
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = import_network("RRDBNet", jnet, variables,
                            {k: v.numpy() for k, v in sd.items()})["params"]
    back = state_dict_from_jax(net, params)
    assert list(back) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("key", ["params_ema", "params"])
def test_esrgan_pth_loads(rng, tmp_path, key):
    """An ESRGAN-layout `.pth` holding `params_ema`, or only `params` as
    Real-ESRGAN ships it, loads strictly into the port and computes what the
    flax net computes on the same weights."""
    jnet, params, x = _jax_rrdb(rng, SMALL, (1, 12, 8, 3))
    src = _port_net(SMALL, params)
    path = tmp_path / "RealESRGAN_x4plus.pth"
    torch.save({key: src.state_dict()}, path)
    net = build_network(SMALL)
    net.load_state_dict(load_pth(str(path), "params_ema"), strict=True)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(net(_t(x)).numpy(), want, **TOL)


def test_packed_rrdbnet_matches_jax(rng):
    """g = 4 block-diagonal packing, float32 (rtol 1e-4 / atol 1e-5, as
    `tests/test_packed_inference.py`) and bf16 (≥ 40 dB)."""
    jnet, params, x = _jax_rrdb(rng, SMALL, (4, 10, 12, 3))
    net = _port_net(SMALL, params)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jpacked.packed_rrdbnet_forward(
            jpacked.pack_rrdbnet_params(params, 2, g=4, dtype=jdt),
            jnp.asarray(x), 2, 4, g=4), np.float32)
        packed = tpacked.pack_rrdbnet_params(net, g=4, dtype=tdt)
        assert packed["blocks.rdb2.conv3"][0].shape == (2, 32, 128, 3, 3)
        got = tpacked.packed_rrdbnet_forward(packed, _t(x), 2, 4, g=4)
        assert got.dtype == tdt and got.shape == (4, 40, 48, 3)
        if tdt == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        else:
            assert _psnr(want, got.float().numpy()) >= 40.0
    with pytest.raises(ValueError):
        tpacked.packed_rrdbnet_forward(packed, _t(x[:3]), 2, 4, g=4)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_packed_and_widened_params_match_jax(rng, g):
    """The port's builders, fed the port's module, give the JAX builders'
    tensors exactly (OIHW against HWIO, blocks stacked on the first axis)."""
    _, params, _ = _jax_rrdb(rng, SMALL, (1, 8, 8, 3))
    net = _port_net(SMALL, params)

    def same(got, want, name):
        want = np.asarray(want)
        if want.ndim >= 4:  # HWIO, maybe stacked → the port's OIHW
            got = got.permute(*range(got.dim() - 4), -2, -1, -3, -4)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)

    jp = jpacked.pack_rrdbnet_params(params, 2, g=g, dtype=jnp.float32)
    tp = tpacked.pack_rrdbnet_params(net, g=g, dtype=torch.float32)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        for got, want in zip(tp[k], jp[k]):
            same(got, want, k)
    jw = jwide.widen_rrdbnet_params(params, 2, g=g, nf=16, gc=8,
                                    dtype=jnp.float32)
    tw = twide.widen_rrdbnet_params(net, g=g, dtype=torch.float32)
    for k in ("conv_first", "conv_last"):
        for got, want in zip(tw[k], jw[k]):
            same(got, want, k)
    for rdb, stages in jw["blocks"].items():
        assert sorted(tw["blocks"][rdb]) == sorted(stages)
        for k, want in stages.items():
            same(tw["blocks"][rdb][k], want, f"{rdb}.{k}")


@pytest.mark.parametrize("g", [1, 2, 4])
def test_widened_rrdbnet_matches_jax(rng, g):
    """The input-grouped form (stage convs nf → 4·gc + nf, gc → …), with g
    tiles packed: float32 against JAX and against the plain port net
    (rtol 1e-4 / atol 1e-5), bf16 against JAX (≥ 40 dB)."""
    jnet, params, x = _jax_rrdb(rng, SMALL, (4, 10, 12, 3))
    net = _port_net(SMALL, params)
    kw = dict(g=g, nf=16, gc=8)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jwide.widened_rrdbnet_forward(
            jwide.widen_rrdbnet_params(params, 2, dtype=jdt, **kw),
            jnp.asarray(x), 2, 4, **kw), np.float32)
        wp = twide.widen_rrdbnet_params(net, g=g, dtype=tdt)
        assert wp["blocks"]["rdb1"]["w0"].shape == (2, g * 48, g * 16, 3, 3)
        got = twide.widened_rrdbnet_forward(wp, _t(x), 2, 4, **kw)
        assert got.dtype == tdt and got.shape == (4, 40, 48, 3)
        if tdt == torch.float32:
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            with torch.no_grad():
                np.testing.assert_allclose(got.numpy(), net(_t(x)).numpy(),
                                           **TOL)
        else:
            assert _psnr(want, got.float().numpy()) >= 40.0


@pytest.fixture(scope="module")
def rrdb_restorers():
    rng = np.random.default_rng(7)
    opt = dict(SMALL, num_block=1)
    jr = JaxRestorer(opt, **tinfer.SR_MEAN_STD)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jr.variables["params"])
    jr.variables = {"params": params}
    tr = tinfer.Restorer(opt, device="cpu", **tinfer.SR_MEAN_STD)
    tr.net.load_state_dict(state_dict_from_jax(tr.net, params), strict=True)
    return jr, tr


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_restore_tiled_rrdbnet_matches_jax(rrdb_restorers, rng):
    jr, tr = rrdb_restorers
    img = rng.random((19, 30, 3)).astype(np.float32)
    kw = dict(tile=8, halo=4, scale=4, tile_batch=4)
    got = tr.restore_tiled(img, **kw)
    assert got.shape == (76, 120, 3)
    assert _lsb(got, jr.restore_tiled(img, **kw)) <= 1
    u8 = (img * 255).astype(np.uint8)
    assert _lsb(tr.restore_tiled_u8(u8, **kw),
                jr.restore_tiled_u8(u8, **kw)) <= 1


def test_restore_tiled_rrdbnet_interior_equals_untiled(rrdb_restorers, rng):
    """One RRDB block: 15 body convs + conv_first + conv_body on the input
    grid (radius 17 px), then three convs on the ×2 and ×4 grids (radius
    under 1 input px): inside a halo of 20 each tiled pixel equals the
    whole-image forward's, away from the image border."""
    tr = rrdb_restorers[1]
    img = rng.random((40, 44, 3)).astype(np.float32)
    x = _t(img[None])
    want = tr._fwd(x)[0].numpy()
    got = ttiling.tiled_apply(tr._fwd, x, tile=16, halo=20, scale=4,
                              tile_batch=3)[0].numpy()
    b = 18 * 4
    np.testing.assert_allclose(got[b:-b, b:-b], want[b:-b, b:-b], **TOL)


def test_cli_rrdbnet_tile_bf16(rng, tmp_path):
    """`--arch rrdbnet --tile N --bf16 --ckpt` at the full ESRGAN width and
    depth (RRDBNET_X4: 64 features, 23 blocks, grow 32) on the CPU: the PNG
    it writes is the tiled bf16 Restorer's output on the same weights."""
    net = build_network(tinfer.RRDBNET_X4, torch.Generator().manual_seed(3))
    ckpt = tmp_path / "esrgan.pth"
    torch.save({"params": net.state_dict()}, ckpt)
    img = (rng.random((20, 14, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img)
    tinfer.main(["--input", str(tmp_path / "in.png"), "--output",
                 str(tmp_path / "out"), "--arch", "rrdbnet", "--tile", "16",
                 "--bf16", "--ckpt", str(ckpt), "--device", "cpu"])
    got = cv2.imread(str(tmp_path / "out" / "in_restored.png"))
    assert got.shape == (80, 56, 3)
    restorer = tinfer.Restorer(tinfer.RRDBNET_X4, str(ckpt),
                               dtype=torch.bfloat16, device="cpu",
                               **tinfer.SR_MEAN_STD)
    rgb = img[..., ::-1].astype(np.float32) / 255.0
    np.testing.assert_array_equal(got, restorer.restore_tiled(rgb, tile=16))
