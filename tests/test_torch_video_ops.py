"""The video slice's ops in the port against the JAX package on the CPU.

* `ops.deform_conv.modulated_deform_conv` against JAX's exact path and
  against the independent numpy reference of `tests/test_video_archs.py`
  (`_naive_deform_conv`): deformable groups whose 2K-channel view crosses
  the o1/o2 halves of `DCNv2Pack`'s concatenation, taps outside the map,
  stride 2, dilation 2, no mask; `max_offset` with offsets beyond R
  against JAX's windowed path (`_mdc_windowed`); the gradients against
  `jax.grad` of the exact path. 1e-5 of max|ref|.
* `archs.arch_util.flow_warp` (one `grid_sample`) against JAX's gather
  path in both padding modes, bilinear and nearest, and with `max_flow`
  against JAX's windowed path; `resize_flow` against JAX's.
* `ops.resize` in the `bilinear_ac` mode: the matrix equal to JAX's and
  the resize within 1e-6.
* `utils.flow_util`: `.flo` and quantized files written by one side read
  by the other, and the (de)quantizers equal to JAX's.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import arch_util as jarch
from image_restoration_tpu.ops import deform_conv as jdcn
from image_restoration_tpu.ops import resize as jresize
from image_restoration_tpu.utils import flow_util as jflow
from image_restoration_tpu_torch.archs import arch_util as tarch
from image_restoration_tpu_torch.ops import resize as tresize
from image_restoration_tpu_torch.ops.deform_conv import modulated_deform_conv
from image_restoration_tpu_torch.utils import flow_util as tflow

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _naive(x, offset, mask, weight, stride=1, padding=1, dilation=1,
           groups=1):
    """A numpy DCNv2: per output pixel and tap, the bilinear sample of each
    group's channels at its offset (zero outside the map) times the mask,
    then the dot with the HWIO weight. `_naive_deform_conv` of
    tests/test_video_archs.py, widened to groups and dilation."""
    n, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    k, cpg = kh * kw, cin // groups
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    out = np.zeros((n, ho, wo, cout), np.float64)
    for b in range(n):
        for i in range(ho):
            for j in range(wo):
                acc = np.zeros(cout)
                for t in range(k):
                    ki, kj = divmod(t, kw)
                    for g in range(groups):
                        oy = offset[b, i, j, g * 2 * k + 2 * t]
                        ox = offset[b, i, j, g * 2 * k + 2 * t + 1]
                        y = i * stride - padding + ki * dilation + oy
                        xx = j * stride - padding + kj * dilation + ox
                        y0, x0 = int(np.floor(y)), int(np.floor(xx))
                        v = np.zeros(cpg)
                        for yy in (y0, y0 + 1):
                            for xc in (x0, x0 + 1):
                                wgt = (1 - abs(y - yy)) * (1 - abs(xx - xc))
                                if 0 <= yy < h and 0 <= xc < w:
                                    v += wgt * x[b, yy, xc,
                                                 g * cpg:(g + 1) * cpg]
                        m = 1.0 if mask is None else \
                            mask[b, i, j, g * k + t]
                        acc += (v * m) @ weight[ki, kj,
                                                g * cpg:(g + 1) * cpg]
                out[b, i, j] = acc
    return out


def _dcn_inputs(seed, n, h, w, cin, cout, groups, stride=1, padding=1,
                dilation=1, scale=3.0):
    rng = np.random.default_rng(seed)
    ho = (h + 2 * padding - dilation * 2 - 1) // stride + 1
    wo = (w + 2 * padding - dilation * 2 - 1) // stride + 1
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    off = (rng.standard_normal((n, ho, wo, 18 * groups)) * scale).astype(
        np.float32)
    mask = rng.random((n, ho, wo, 9 * groups)).astype(np.float32)
    wt = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, off, mask, wt, b


def _port_dcn(x, off, mask, wt, b, **kw):
    return modulated_deform_conv(
        torch.from_numpy(x), torch.from_numpy(off),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
        None if b is None else torch.from_numpy(b), **kw)


DCN_CASES = [  # n, h, w, cin, cout, groups, stride, padding, dilation
    (2, 9, 11, 8, 5, 2, 1, 1, 1),
    (1, 12, 10, 16, 6, 4, 1, 1, 1),
    (2, 9, 11, 8, 5, 2, 2, 1, 1),
    (1, 13, 11, 8, 4, 1, 1, 2, 2),
]


@pytest.mark.parametrize("case", DCN_CASES,
                         ids=["g2", "g4", "stride2", "dilation2"])
def test_deform_conv_matches_jax_exact(case):
    """Offsets of ±3σ px (many taps leave the map), masks in [0, 1), a
    bias: 1e-5 of max|ref| against JAX's exact path."""
    n, h, w, cin, cout, g, s, p, d = case
    x, off, mask, wt, b = _dcn_inputs(1600, n, h, w, cin, cout, g, s, p, d)
    want = jdcn.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
        jnp.asarray(wt), jnp.asarray(b), s, p, d, g)
    got = _port_dcn(x, off, mask, wt, b, stride=s, padding=p, dilation=d,
                    deformable_groups=g)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("with_mask", [True, False])
def test_deform_conv_matches_numpy_reference(with_mask):
    """Two deformable groups over 4 channels: group 0's 18 offset channels
    are o1's first 18 and group 1's straddle o1 (9) and o2 (9), the layout
    `DCNv2Pack` hands the op; against the numpy reference in float64."""
    x, off, mask, wt, b = _dcn_inputs(1601, 1, 6, 7, 4, 5, 2)
    mask = mask if with_mask else None
    want = _naive(x.astype(np.float64), off, mask, wt, groups=2)
    got = _port_dcn(x, off, mask, wt, None, deformable_groups=2)
    assert _rel(got, want) <= TOL


def test_dcnv2pack_group_view_crosses_the_offset_halves():
    """`DCNv2Pack` passes cat(o1, o2) through: with 8 groups the op reads
    group g's taps at channels 18g…18g+17 of it, so group 4 onwards take
    their (y, x) pairs from o2. Re-deriving y = o1, x = o2 gives another
    output, so only the pass-through keeps reference weights valid."""
    from image_restoration_tpu_torch.archs.edvr_arch import DCNv2Pack
    from image_restoration_tpu_torch.archs import init_weights
    gen = torch.Generator().manual_seed(1)
    pack = DCNv2Pack(16, 8, deformable_groups=8)
    init_weights(pack, gen)
    x = torch.randn(1, 6, 6, 16, generator=gen)
    feat = torch.randn(1, 6, 6, 16, generator=gen)
    out = pack.conv_offset(feat)
    o1, o2, m = torch.chunk(out, 3, dim=-1)
    want = modulated_deform_conv(x, torch.cat([o1, o2], -1), torch.sigmoid(m),
                                 pack.weight, pack.bias,
                                 deformable_groups=8)
    assert torch.allclose(pack(x, feat), want, atol=1e-6)
    yx = torch.stack([o1, o2], -1).reshape(1, 6, 6, -1)  # y = o1, x = o2
    other = modulated_deform_conv(x, yx, torch.sigmoid(m), pack.weight,
                                  pack.bias, deformable_groups=8)
    assert (other - want).abs().max() > 1e-2


@pytest.mark.parametrize("R", [1, 3])
def test_deform_conv_max_offset_matches_jax_windowed(R):
    """Offsets of σ = 3 px, most beyond R: the port clamps them to ±R and
    samples exactly, JAX's windowed path (block 4) clamps and samples in
    windows; 1e-5 of max|ref|, and both differ from the unclamped op."""
    x, off, mask, wt, b = _dcn_inputs(1602, 1, 12, 10, 8, 4, 2)
    want = jdcn.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
        jnp.asarray(wt), jnp.asarray(b), deformable_groups=2, max_offset=R,
        block=4)
    got = _port_dcn(x, off, mask, wt, b, deformable_groups=2, max_offset=R)
    assert _rel(got, want) <= TOL
    exact = _port_dcn(x, off, mask, wt, b, deformable_groups=2)
    assert _rel(exact, want) > 1e-2


def test_deform_conv_gradients_match_jax():
    """d(Σ out·c)/d(x, offset, mask, weight, bias) by autograd against
    jax.grad of JAX's exact op: 1e-5 of each max|grad|."""
    x, off, mask, wt, b = _dcn_inputs(1603, 1, 8, 9, 8, 6, 2, scale=1.5)
    c = np.random.default_rng(1604).standard_normal((1, 8, 9, 6)).astype(
        np.float32)

    def jloss(x, off, mask, wt, b):
        y = jdcn.modulated_deform_conv(x, off, mask, wt, b,
                                       deformable_groups=2)
        return jnp.sum(y * c)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in (x, off, mask, wt, b)])
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, off, mask, wt.transpose(3, 2, 0, 1).copy(), b)]
    y = modulated_deform_conv(*ts, deformable_groups=2)
    (y * torch.from_numpy(c)).sum().backward()
    got = [t.grad.numpy() for t in ts]
    got[3] = got[3].transpose(2, 3, 1, 0)
    for name, g, w in zip(("x", "offset", "mask", "weight", "bias"), got,
                          want):
        assert _rel(g, w) <= TOL, name


# ------------------------------------------------------------ flow warp

@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp_matches_jax(padding, interp):
    """Flows of σ = 4 px over a 16×20 map (many samples leave it)."""
    rng = np.random.default_rng(1610)
    x = rng.standard_normal((2, 16, 20, 3)).astype(np.float32)
    f = (rng.standard_normal((2, 16, 20, 2)) * 4).astype(np.float32)
    want = jarch.flow_warp(jnp.asarray(x), jnp.asarray(f), interp, padding)
    got = tarch.flow_warp(torch.from_numpy(x), torch.from_numpy(f), interp,
                          padding)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp_max_flow_matches_jax_windowed(padding):
    rng = np.random.default_rng(1611)
    x = rng.standard_normal((2, 16, 20, 3)).astype(np.float32)
    f = (rng.standard_normal((2, 16, 20, 2)) * 4).astype(np.float32)
    want = jarch.flow_warp(jnp.asarray(x), jnp.asarray(f), "bilinear",
                           padding, max_flow=2, block=8)
    got = tarch.flow_warp(torch.from_numpy(x), torch.from_numpy(f),
                          "bilinear", padding, max_flow=2)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("size_type,sizes", [("ratio", (2, 0.5)),
                                             ("shape", (9, 31))])
def test_resize_flow_matches_jax(size_type, sizes):
    f = np.random.default_rng(1612).standard_normal((2, 12, 16, 2)).astype(
        np.float32)
    want = jarch.resize_flow(jnp.asarray(f), size_type, sizes)
    got = tarch.resize_flow(torch.from_numpy(f), size_type, sizes)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("io", [(2, 4), (3, 6), (5, 9), (8, 8), (6, 1),
                                (4, 2)])
def test_bilinear_ac_matches_jax(io):
    """The align_corners=True matrix equal to JAX's; a resize of a 2×6×5
    batch by it within 1e-6 of max|ref|."""
    i, o = io
    np.testing.assert_array_equal(
        tresize.cv2_resize_matrix(i, o, "bilinear_ac"),
        jresize.cv2_resize_matrix(i, o, "bilinear_ac"))
    x = np.random.default_rng(1613).random((2, i, 5, 2)).astype(np.float32)
    want = jresize.resize(jnp.asarray(x), (o, 7), "bilinear_ac")
    got = tresize.resize(torch.from_numpy(x), (o, 7), "bilinear_ac")
    assert _rel(got, want) <= 1e-6


# ------------------------------------------------------------- flow files

def test_flo_round_trip_both_ways(tmp_path):
    flow = np.random.default_rng(1620).standard_normal((7, 9, 2)).astype(
        np.float32)
    tflow.flowwrite(flow, str(tmp_path / "t.flo"))
    jflow.flowwrite(flow, str(tmp_path / "j.flo"))
    assert (tmp_path / "t.flo").read_bytes() == \
        (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(jflow.flowread(str(tmp_path / "t.flo")),
                                  flow)
    np.testing.assert_array_equal(tflow.flowread(str(tmp_path / "j.flo")),
                                  flow)
    (tmp_path / "bad.flo").write_bytes(b"XXXX" + bytes(8))
    with pytest.raises(IOError):
        tflow.flowread(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("axis", [0, 1])
def test_quantized_flow_round_trip_both_ways(tmp_path, axis):
    """Quantized PNGs byte-equal; each side reads the other's to the same
    dequantized flow, within one bin of the written one."""
    flow = (np.random.default_rng(1621).uniform(-0.15, 0.15, (8, 10, 2))
            ).astype(np.float32)  # inside ±max_val·size: no value clips
    t, j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tflow.flowwrite(flow, t, quantize=True, concat_axis=axis)
    jflow.flowwrite(flow, j, quantize=True, concat_axis=axis)
    assert open(t, "rb").read() == open(j, "rb").read()
    got = tflow.flowread(j, quantize=True, concat_axis=axis)
    want = jflow.flowread(t, quantize=True, concat_axis=axis)
    np.testing.assert_array_equal(got, want)
    assert osp.getsize(t) > 0
    bin_w = 0.04 / 255 * np.array([10, 8])
    assert np.all(np.abs(got - flow) <= bin_w)


def test_quantizers_match_jax():
    rng = np.random.default_rng(1622)
    flow = (rng.standard_normal((5, 6, 2)) * 0.2).astype(np.float32)
    for norm in (True, False):
        for a, b in zip(tflow.quantize_flow(flow, 0.5, norm),
                        jflow.quantize_flow(flow, 0.5, norm)):
            np.testing.assert_array_equal(a, b)
    dx, dy = jflow.quantize_flow(flow)
    np.testing.assert_array_equal(tflow.dequantize_flow(dx, dy),
                                  jflow.dequantize_flow(dx, dy))
