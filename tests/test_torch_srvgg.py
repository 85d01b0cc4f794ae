"""Port SRVGGNetCompact, pixel shuffle, packed bf16 path, halo tiling and the
tiled Restorer against the JAX package: the same weights (flax params through
`state_dict_from_jax`, or a Real-ESRGAN `state_dict` through the JAX
importer) and the same numpy inputs go to both. Float paths agree to
1e-5 abs / 1e-4 rel (f32 summation order); tiling is index arithmetic and
agrees exactly; uint8 outputs agree to 1 LSB."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.torch_import import import_network
from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu.infer import main as jax_main
from image_restoration_tpu.ops import packed_inference as jpacked
from image_restoration_tpu.ops import pixel_ops as jpix
from image_restoration_tpu.parallel import tiling as jtiling
from image_restoration_tpu_torch import infer as tinfer
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.convert.pth import load_pth
from image_restoration_tpu_torch.ops import packed_inference as tpacked
from image_restoration_tpu_torch.ops import pixel_ops as tpix
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_srvgg(rng, shape=(2, 10, 12, 3), **kw):
    """A flax SRVGGNetCompact with every parameter drawn from rng (biases and
    PReLU slopes too, so every leaf carries data)."""
    opt = dict(type="SRVGGNetCompact", **kw)
    net = jax_build(opt)
    x = rng.random(shape).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    return net, params, x, opt


def _port_net(opt, params):
    net = build_network(opt)
    net.load_state_dict(state_dict_from_jax(net, params), strict=True)
    return net.eval()


@pytest.mark.parametrize("scale", [2, 4])
def test_pixel_shuffle_matches_jax(rng, scale):
    x = rng.standard_normal((2, 5, 7, 3 * scale * scale)).astype(np.float32)
    got = tpix.pixel_shuffle(_t(x), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpix.pixel_shuffle(
        jnp.asarray(x), scale)))
    y = rng.standard_normal((2, 5 * scale, 7 * scale, 3)).astype(np.float32)
    got = tpix.pixel_unshuffle(_t(y), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpix.pixel_unshuffle(
        jnp.asarray(y), scale)))
    np.testing.assert_array_equal(
        tpix.pixel_shuffle(tpix.pixel_unshuffle(_t(y), scale), scale).numpy(),
        y)
    # torch's channel order: NCHW pixel_shuffle on the same values
    ref = torch.nn.functional.pixel_shuffle(_t(x).permute(0, 3, 1, 2), scale)
    np.testing.assert_array_equal(tpix.pixel_shuffle(_t(x), scale).numpy(),
                                  ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("act_type", ["prelu", "relu", "leakyrelu"])
def test_srvgg_matches_flax(rng, act_type):
    jnet, params, x, opt = _jax_srvgg(rng, num_feat=16, num_conv=3,
                                      upscale=4, act_type=act_type)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = _port_net(opt, params)
    with torch.no_grad():
        got = net(_t(x)).numpy()
    assert got.shape == (2, 40, 48, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_srvgg_bf16_dtype_matches_flax(rng):
    """dtype=bf16 runs every conv in bf16, as flax's `dtype` does; the two
    frameworks round at the same places, so they agree to bf16 precision."""
    jnet, params, x, opt = _jax_srvgg(rng, num_feat=16, num_conv=2,
                                      upscale=2, dtype=jnp.bfloat16)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    net = _port_net(dict(opt, dtype="bf16"), params)
    with torch.no_grad():
        got = net(_t(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_srvgg_realesrgan_state_dict_round_trip(rng, tmp_path):
    """A Real-ESRGAN-layout checkpoint ({'params': state_dict}, `body.N`
    keys) loads into the port with `load_state_dict` and into the flax net
    through the JAX importer; both nets then agree, and mapping the flax
    params back gives the checkpoint exactly."""
    opt = dict(type="SRVGGNetCompact", num_feat=16, num_conv=4, upscale=4)
    src = build_network(opt, torch.Generator().manual_seed(7))
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(i))
          for i, (k, v) in enumerate(src.state_dict().items())}
    assert sorted(sd) == sorted(
        [f"body.{2 * i}.{p}" for i in range(5) for p in ("weight", "bias")]
        + [f"body.{2 * i + 1}.weight" for i in range(5)]
        + ["body.10.weight", "body.10.bias"])
    path = tmp_path / "realesr-general-x4v3.pth"
    torch.save({"params": sd}, path)

    net = build_network(opt)
    net.load_state_dict(load_pth(str(path), "params_ema"), strict=True)
    jnet, _, x, _ = _jax_srvgg(rng, num_feat=16, num_conv=4, upscale=4)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = import_network("SRVGGNetCompact", jnet, variables,
                            {k: v.numpy() for k, v in sd.items()})["params"]
    back = state_dict_from_jax(net, params)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(net(_t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("upscale", [2, 4])
def test_packed_srvgg_forward_matches_jax(rng, upscale):
    jnet, params, x, opt = _jax_srvgg(rng, shape=(4, 12, 10, 3),
                                      num_feat=16, num_conv=3,
                                      upscale=upscale)
    want = np.asarray(jpacked.packed_srvgg_forward(
        jpacked.pack_srvgg_params(params, 3, dtype=jnp.float32),
        jnp.asarray(x), 3, upscale))
    net = _port_net(opt, params)
    packed = tpacked.pack_srvgg_params(net, dtype=torch.float32)
    got = tpacked.packed_srvgg_forward(packed, _t(x), 3, upscale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, net(_t(x)).numpy(), **TOL)
    with pytest.raises(ValueError):
        tpacked.packed_srvgg_forward(packed, _t(x[:3]), 3, upscale)


def test_block_diag_matches_jax(rng):
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)  # HWIO
    want = np.asarray(jpacked._block_diag(jnp.asarray(w), 3))
    got = tpacked._block_diag(_t(w.transpose(3, 2, 0, 1)), 3)  # OIHW
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)
    got = tpacked._block_diag(_t(w.transpose(3, 0, 1, 2)), 3, in_dim=3)
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 3, 0), want)


# (N, H, W, tile, halo): whole grids, ragged grids, and pads wider than the
# image (a 120×360 plate at tile 512 pads 8 + 392 rows: reflected again and
# again, which torch's F.pad refuses)
TILE_CASES = [(1, 32, 48, 16, 4), (2, 21, 17, 8, 3), (1, 5, 3, 8, 2),
              (1, 120, 360, 512, 8)]


@pytest.mark.parametrize("n,h,w,tile,halo", TILE_CASES)
def test_tile_untile_match_jax(rng, n, h, w, tile, halo):
    img = rng.standard_normal((n, h, w, 3)).astype(np.float32)
    jt, jgrid = jtiling.tile_image(jnp.asarray(img), tile, halo)
    tt, tgrid = ttiling.tile_image(_t(img), tile, halo)
    assert tgrid == jgrid
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for scale in (1, 2):
        big = np.repeat(np.repeat(np.asarray(jt), scale, 1), scale, 2)
        want = np.asarray(jtiling.untile_image(jnp.asarray(big), jgrid, tile,
                                               halo, scale))
        got = ttiling.untile_image(_t(big), tgrid, tile, halo, scale).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape == (n, h * scale, w * scale, 3)


@pytest.mark.parametrize("tile_batch,out_halo", [(None, None), (4, None),
                                                 (6, 0)])
def test_tiled_apply_matches_jax(rng, tile_batch, out_halo):
    """A chunked run with a zero-padded last chunk (15 tiles in chunks of 4
    or 6), and fn cropping its own halo (out_halo=0), stitch as in JAX."""
    img = rng.standard_normal((1, 27, 50, 3)).astype(np.float32)
    tile, halo, scale = 10, 3, 2
    p = halo * scale if out_halo == 0 else 0
    calls = []

    def jfn(t):  # ×2 nearest upsample of 2t + 1, cropped by p
        y = jnp.repeat(jnp.repeat(t * 2.0 + 1.0, scale, 1), scale, 2)
        return y[:, p:y.shape[1] - p, p:y.shape[2] - p]

    def tfn(t):
        calls.append(t.shape[0])
        y = (t * 2.0 + 1.0).repeat_interleave(scale, 1).repeat_interleave(
            scale, 2)
        return y[:, p:y.shape[1] - p, p:y.shape[2] - p]

    want = np.asarray(jtiling.tiled_apply(
        jfn, jnp.asarray(img), tile, halo, scale, tile_batch=tile_batch,
        out_halo=out_halo))
    got = ttiling.tiled_apply(tfn, _t(img), tile, halo, scale,
                              tile_batch=tile_batch,
                              out_halo=out_halo).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(calls) == {tile_batch or 15}  # every chunk at the same size
    # over a mesh of two devices (the CPU twice): the same stitched result;
    # a process-group mesh is not a set of local devices and raises
    from image_restoration_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(["cpu", "cpu"])
    on_mesh = ttiling.tiled_apply(tfn, _t(img), tile, halo, scale,
                                  tile_batch=tile_batch, mesh=mesh,
                                  out_halo=out_halo).numpy()
    mesh.close()
    np.testing.assert_array_equal(on_mesh, want)
    with pytest.raises(ValueError):
        ttiling.tiled_apply(tfn, _t(img), tile, halo,
                            mesh=Mesh(["cpu"], world=True))


@pytest.fixture(scope="module")
def sr_restorers():
    rng = np.random.default_rng(5)
    opt = dict(type="SRVGGNetCompact", num_feat=16, num_conv=3, upscale=4)
    mean_std = dict(mean=(0, 0, 0), std=(1, 1, 1), out_min_max=(0, 1))
    jr = JaxRestorer(opt, **mean_std)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jr.variables["params"])
    jr.variables = {"params": params}
    tr = tinfer.Restorer(opt, device="cpu", **mean_std)
    tr.net.load_state_dict(state_dict_from_jax(tr.net, params), strict=True)
    return jr, tr


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_restore_tiled_matches_jax(sr_restorers, rng):
    jr, tr = sr_restorers
    img = rng.random((19, 30, 3)).astype(np.float32)
    kw = dict(tile=8, halo=4, scale=4, tile_batch=4)
    got = tr.restore_tiled(img, **kw)
    assert got.shape == (76, 120, 3)
    assert _lsb(got, jr.restore_tiled(img, **kw)) <= 1
    u8 = (img * 255).astype(np.uint8)
    got_u8 = tr.restore_tiled_u8(u8, **kw)
    assert _lsb(got_u8, jr.restore_tiled_u8(u8, **kw)) <= 1
    assert _lsb(got_u8, tr.restore_tiled(u8.astype(np.float32) / 255,
                                         **kw)) <= 1
    with pytest.raises(TypeError):
        tr.restore_tiled_u8(img, **kw)


def test_restore_tiled_interior_equals_untiled(sr_restorers, rng):
    """The receptive field of a 3-conv ×4 net is 5 px, inside a halo of 6:
    every output pixel of the tiled run equals the whole-image forward's,
    except where the reflect border differs from the conv's zero border."""
    tr = sr_restorers[1]
    img = rng.random((24, 40, 3)).astype(np.float32)
    x = _t(img[None])
    want = tr._fwd(x)[0].numpy()
    got = ttiling.tiled_apply(tr._fwd, x, tile=8, halo=6, scale=4,
                              tile_batch=3)[0].numpy()
    b = 5 * 4
    np.testing.assert_allclose(got[b:-b, b:-b], want[b:-b, b:-b], **TOL)


def test_cli_srvgg_tile_matches_jax(rng, tmp_path):
    """`--arch srvgg --tile N` at the full realesr-general width and depth
    (64 features, 32 convs), from a Real-ESRGAN `.pth`, on a small image."""
    net = build_network(tinfer.SRVGG_X4, torch.Generator().manual_seed(3))
    ckpt = tmp_path / "srvgg.pth"
    torch.save({"params_ema": net.state_dict()}, ckpt)
    img = (rng.random((20, 14, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img)
    outs = {}
    for name, main, extra in [("port", tinfer.main, ["--device", "cpu"]),
                              ("jax", jax_main, [])]:
        out_dir = tmp_path / name
        main(["--input", str(tmp_path / "in.png"), "--output", str(out_dir),
              "--arch", "srvgg", "--tile", "16", "--ckpt", str(ckpt)]
             + extra)
        outs[name] = cv2.imread(str(out_dir / "in_restored.png"))
    assert outs["port"].shape == (80, 56, 3)
    assert _lsb(outs["port"], outs["jax"]) <= 1
