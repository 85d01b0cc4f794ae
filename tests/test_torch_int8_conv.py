"""Kernel K2's plain version and the port's int8 SRVGG chain against the JAX
package: the Pallas kernel (interpret mode), the jnp layer formulas, the
calibration, the quantized pytree and `quantized_srvgg_forward`. Integer
outputs agree exactly; the calibration maxima to 1e-5 relative (f32
summation order of the float convs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.ops import quantized_inference as jq
from image_restoration_tpu.ops.pallas.int8_conv import (
    int8_conv3x3_requant as pallas_int8_conv)
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.ops import quantized_inference as tq
from image_restoration_tpu_torch.ops.int8_conv import (
    int8_conv3x3_requant, int8_conv3x3_requant_plain)

DN = ("NHWC", "HWIO", "NHWC")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _jax_acc(x, w_hwio, padding):
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_hwio), (1, 1), padding,
        dimension_numbers=DN, preferred_element_type=jnp.int32)


def test_plain_f32_matches_pallas_interpret(rng):
    """As tests/test_packed_inference.py runs the Pallas kernel: a
    pre-padded input whose border is random, not zero (pad=0)."""
    h, w, c = 16, 16, 128
    xp = _i8(rng, (h + 2, w + 2, c))
    wt = _i8(rng, (3, 3, c, c))
    deq = (rng.random(c) * 1e-3).astype(np.float32)
    b = (rng.random(c) * 1e-2).astype(np.float32)
    a = np.full(c, 0.25, np.float32)
    for so in (1.0, 0.37):
        want = pallas_int8_conv(jnp.asarray(xp), jnp.asarray(wt),
                                jnp.asarray(deq), jnp.asarray(b),
                                jnp.asarray(a), jnp.float32(so), bh=8,
                                interpret=True)
        got = int8_conv3x3_requant_plain(
            _t(xp[None]), _t(wt.transpose(3, 0, 1, 2)), _t(deq), _t(b),
            _t(a), so, pad=0, epilogue="f32")
        assert got.shape == (1, h, w, c)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        assert np.abs(np.asarray(want)).max() == 127  # the clip is reached


@pytest.mark.parametrize("pad", [0, 1])
def test_plain_f32_cin_ne_cout_matches_jnp(rng, pad):
    """Batched, Cin ≠ Cout, both pads, with and without PReLU, against the
    Pallas kernel's jnp formula."""
    n, h, w, cin, cout = 2, 9, 11, 6, 24
    x = _i8(rng, (n, h, w, cin))
    wt = _i8(rng, (3, 3, cin, cout))
    deq = (rng.random(cout) * 2e-3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    a = rng.random(cout).astype(np.float32)
    so = np.float32(20.0)
    acc = _jax_acc(x, wt, "VALID" if pad == 0 else ((1, 1), (1, 1)))
    for alpha in (a, None):
        hf = acc.astype(jnp.float32) * deq + b
        if alpha is not None:
            hf = jnp.where(hf >= 0, hf, hf * alpha)
        want = jnp.clip(jnp.round(hf * (127.0 / so)), -127, 127).astype(
            jnp.int8)
        got = int8_conv3x3_requant(
            _t(x), _t(wt.transpose(3, 0, 1, 2)), _t(deq), _t(b),
            None if alpha is None else _t(alpha), float(so), pad=pad,
            epilogue="f32")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cin,cout", [(6, 32), (32, 32), (32, 48)])
def test_plain_bf16_matches_jax_chain_layer(rng, cin, cout):
    """The bf16 epilogue against the JAX chain's layer expression
    (`quantized_inference.py:134-141`, and :147-155 without PReLU) under
    jax.jit, at the chain's SAME padding."""
    x = _i8(rng, (2, 10, 13, cin))
    wt = _i8(rng, (3, 3, cin, cout))
    # |acc·deq| reaches ~100, so both the rounding and the clip matter
    scale = 100.0 / (np.sqrt(9 * cin) * 127 ** 2 / 3)
    deq = jnp.asarray(rng.random(cout) * scale, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(cout) * 5, jnp.bfloat16)
    a = jnp.asarray(rng.random(cout), jnp.bfloat16)

    @jax.jit
    def layer(hq, w, deq, b, a):
        acc = jax.lax.conv_general_dilated(
            hq, w, (1, 1), ((1, 1), (1, 1)), dimension_numbers=DN,
            preferred_element_type=jnp.int32)
        hf = acc.astype(jnp.bfloat16) * deq + b
        if a is not None:
            hf = jnp.where(hf >= 0, hf, hf * a)
        return jnp.clip(jnp.round(hf), -127, 127).astype(jnp.int8)

    def bf(v):
        return torch.from_numpy(np.asarray(v, np.float32)).bfloat16()

    for alpha in (a, None):
        want = np.asarray(layer(jnp.asarray(x), jnp.asarray(wt), deq, b,
                                alpha))
        got = int8_conv3x3_requant(
            _t(x), _t(wt.transpose(3, 0, 1, 2)), bf(deq), bf(b),
            None if alpha is None else bf(alpha), epilogue="bf16")
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.abs(want).max() == 127


def test_wrapper_dispatch_and_checks(rng):
    """CPU tensors take the plain version and count no launch; a device
    that is neither CPU nor CUDA and malformed arguments raise."""
    x = _t(_i8(rng, (1, 5, 6, 8)))
    wt = _t(_i8(rng, (4, 3, 3, 8)))
    p = torch.ones(4)
    before = int8_conv3x3_requant.launches
    out = int8_conv3x3_requant(x, wt, p * 1e-3, p)
    assert out.shape == (1, 5, 6, 4) and out.dtype == torch.int8
    assert torch.equal(out, int8_conv3x3_requant_plain(x, wt, p * 1e-3, p))
    assert int8_conv3x3_requant.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        int8_conv3x3_requant(x.to("meta"), wt.to("meta"), p.to("meta"),
                             p.to("meta"))
    with pytest.raises(TypeError):
        int8_conv3x3_requant(x.float(), wt, p, p)
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x, wt[..., :4], p, p)  # Cin mismatch
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x, wt, p[:3], p)
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x, wt, p, p, pad=2)
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x, wt, p, p, epilogue="f32")  # no s_out


# ------------------------------------- K2's tiled walk, emulated on the CPU
#
# csrc/int8_conv3x3.cu as blocks of PyTorch: the wrapper pads Cin to 32; a
# block holds NT output channels (Cout rounded up to 64, at most 192, less
# while shared memory does not hold them); tiles of 8 × 24 output pixels in
# persistent order (block b takes tiles b, b + G, …; co-block outermost, then
# image, tile row, tile column); three warpgroups each own an 8 × 8 part and
# gather its 10 × 10 slab with the halo, zero outside the image; K runs over
# the 9 taps and, within a tap, 32-channel chunks; the epilogue takes the
# fast path for a thread whose sums all lie in [-2^22, 2^22) and the scalar
# path otherwise; H, W and Cout are masked at the store.

K2_TH, K2_PART_W, K2_WGS, K2_MAX_NT = 8, 8, 3, 192
K2_MAX_SMEM = 232448


def _k2_smem(nt, cin, epilogue):
    esize = 2 if epilogue == "bf16_deq" else 1
    return (9 * cin * nt + K2_WGS * cin * (K2_TH + 2) * (K2_PART_W + 2)
            + K2_WGS * K2_TH * K2_PART_W * (nt * esize + 16) + 3 * nt * 4
            + 3 * nt // 2 * 4)


def _k2_nt(cin, cout, epilogue):
    nt = min(-(-cout // 64) * 64, K2_MAX_NT)
    while nt > 64 and _k2_smem(nt, cin, epilogue) > K2_MAX_SMEM:
        nt -= 64
    return nt


def _bf16_round(x):
    """float64 → the nearest bf16 value (half to even), rounded once."""
    _, e = torch.frexp(x)  # x = m·2^e, 0.5 <= |m| < 1: 8 significant bits
    ulp = torch.exp2(e.double() - 8)
    return torch.where(x == 0, x, torch.round(x / ulp) * ulp)


def _k2_fast_epilogue(acc, deq, bias, alpha, s_out, epilogue):
    """The kernel's fast epilogue, operation by operation: acc exact in f32,
    bf16 products and sums rounded once, PReLU as min(h, 0)·a + max(h, 0)
    rounded once, the clip before round half to even. A missing bias is -0
    and a missing alpha 1."""
    cout = acc.shape[-1]
    f = acc.float()
    if epilogue == "f32":
        b = bias.float()
        a = torch.ones(cout) if alpha is None else alpha.float()
        h = f * deq.float() + b
        h = torch.where(h >= 0, h, h * a)
        ratio = float(np.float32(127.0) / np.float32(s_out))
        return torch.round(torch.clamp(h * ratio, -127, 127)).to(torch.int8)
    b = (torch.full((cout,), -0.0) if bias is None else bias.float()).double()
    h = f.bfloat16().double() * deq.bfloat16().double()  # exact
    h = _bf16_round(_bf16_round(h) + b)
    if epilogue == "bf16_deq":
        return h.bfloat16()
    a = torch.ones(cout, dtype=torch.float64) if alpha is None else \
        alpha.bfloat16().double()
    h = _bf16_round(torch.clamp(h, max=0) * a + torch.clamp(h, min=0))
    return torch.round(torch.clamp(h, -127, 127)).to(torch.int8)


def _k2_walk(x, weight, deq, bias, alpha, s_out, pad, epilogue, grid):
    """K2's walk over x (N, H, W, Cin) for a persistent grid of `grid`
    blocks; its output must equal int8_conv3x3_requant_plain's."""
    from image_restoration_tpu_torch.ops.int8_conv import (
        CIN_MULTIPLE, EPILOGUES, requant_epilogue)
    n, hin, win, _ = x.shape
    cout = weight.shape[0]
    cin = -(-x.shape[3] // CIN_MULTIPLE) * CIN_MULTIPLE
    xp = torch.nn.functional.pad(x, (0, cin - x.shape[3])).double()
    wp = torch.nn.functional.pad(weight, (0, cin - weight.shape[3])).double()
    hout, wout = hin + 2 * pad - 2, win + 2 * pad - 2
    nt = _k2_nt(cin, cout, epilogue)
    tw = K2_WGS * K2_PART_W
    tiles_x, tiles_y = -(-wout // tw), -(-hout // K2_TH)
    tiles_co = n * tiles_y * tiles_x
    num_tiles = tiles_co * -(-cout // nt)
    out = torch.full((n, hout, wout, cout), 99, dtype=EPILOGUES[epilogue][2])
    # thread of each (pixel, channel) of a part: warp rows 2·wq, 2·wq + 1,
    # lane column g, lane channel pair q
    pix = torch.arange(K2_TH * K2_PART_W)[:, None]
    ch = torch.arange(nt)[None, :]
    thread = ((pix // K2_PART_W) // 2 * 32 + pix % K2_PART_W * 4
              + ch % 8 // 2).expand(-1, nt)
    for b in range(min(grid, num_tiles)):
        for t in range(b, num_tiles, grid):
            co, r = divmod(t, tiles_co)
            img, r = divmod(r, tiles_y * tiles_x)
            ty, tx = divmod(r, tiles_x)
            co0 = co * nt
            w_blk = torch.zeros(nt, 9, cin, dtype=torch.float64)
            w_blk[:min(nt, cout - co0)] = wp[co0:co0 + nt].reshape(-1, 9, cin)
            for wg in range(K2_WGS):
                y0, x0 = ty * K2_TH, tx * tw + wg * K2_PART_W
                slab = torch.zeros(K2_TH + 2, K2_PART_W + 2, cin,
                                   dtype=torch.float64)
                for i in range(K2_TH + 2):
                    for j in range(K2_PART_W + 2):
                        iy, ix = y0 - pad + i, x0 - pad + j
                        if 0 <= iy < hin and 0 <= ix < win:
                            slab[i, j] = xp[img, iy, ix]
                acc = torch.zeros(K2_TH * K2_PART_W, nt, dtype=torch.float64)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    a_tap = slab[dy:dy + K2_TH, dx:dx + K2_PART_W].reshape(
                        -1, cin)
                    for c in range(0, cin, 32):
                        acc += a_tap[:, c:c + 32] @ w_blk[:, tap, c:c + 32].t()
                acc = acc.to(torch.int64)
                keep = min(nt, cout - co0)
                par = [None if p is None else torch.cat(
                    [p[co0:co0 + keep], torch.zeros(nt - keep, dtype=p.dtype)])
                       for p in (deq, bias, alpha)]
                small = ((acc >= -2 ** 22) & (acc < 2 ** 22)).long()
                fast_thread = torch.ones(128, dtype=torch.long).scatter_reduce(
                    0, thread.reshape(-1), small.reshape(-1), "amin")
                fast = fast_thread[thread].bool()
                res = torch.where(
                    fast, _k2_fast_epilogue(acc, *par, s_out, epilogue),
                    requant_epilogue(acc, *par, s_out, epilogue))
                rows = min(K2_TH, hout - y0)
                cols = min(K2_PART_W, wout - x0)
                if rows <= 0 or cols <= 0:
                    continue
                res = res.reshape(K2_TH, K2_PART_W, nt)
                out[img, y0:y0 + rows, x0:x0 + cols, co0:co0 + keep] = \
                    res[:rows, :cols, :keep]
    return out


def _k2_case_inputs(rng, n, h, w, cin, cout, epilogue, prelu, with_bias,
                    saturate):
    """int8 x and weights; deq spreads |acc·deq| to about 100 and the bias
    spans ten decades, so bf16 sums meet operands of very different size."""
    pdt = torch.float32 if epilogue == "f32" else torch.bfloat16
    x = _i8(rng, (n, h, w, cin))
    wt = _i8(rng, (cout, 3, 3, cin))
    if saturate:  # sums ≥ 2^22 in one corner: those threads take the scalar path
        x[:, :5, :6] = 127
        wt[:min(cout, 9)] = 127
    scale = 100.0 / (np.sqrt(9 * cin) * 127 ** 2 / 3)
    deq = torch.from_numpy(rng.random(cout) * scale).to(pdt)
    b = torch.from_numpy(rng.standard_normal(cout)
                         * 10.0 ** rng.uniform(-6, 4, cout)).to(pdt)
    a = torch.from_numpy(rng.random(cout)).to(pdt)
    return (_t(x), _t(wt), deq, b if with_bias else None,
            a if prelu else None)


@pytest.mark.parametrize("n,h,w,cin,cout,pad,epilogue,grid,saturate", [
    (1, 3, 528, 6, 96, 1, "bf16", 132, False),       # a served row, body_0's Cin
    (1, 2, 528, 6, 160, 1, "bf16_deq", 132, False),
    (1, 2, 528, 6, 192, 1, "f32", 132, False),
    (2, 11, 30, 10, 24, 1, "bf16", 3, True),         # ragged, tiles straddle images
    (3, 9, 27, 4, 3, 0, "f32", 2, True),             # VALID over a pre-padded input
    (2, 10, 26, 24, 36, 0, "bf16_deq", 5, True),
    (1, 1, 40, 64, 192, 1, "bf16_deq", 132, False),  # H = 1, one 192-channel block
    (1, 9, 30, 160, 200, 1, "bf16", 4, True),        # Cin 160, two co-blocks
    (1, 6, 17, 192, 70, 1, "bf16_deq", 7, False),    # Cin 192: smem allows NT 64
])
def test_k2_tiled_walk_matches_plain(rng, n, h, w, cin, cout, pad, epilogue,
                                     grid, saturate):
    """K2's walk (tiles, persistent order, slab gather, Cin padding, k32
    chunks per tap, fast and scalar epilogues, masking) equals the plain
    version bit for bit, with and without bias and PReLU."""
    variants = ([(False, True), (False, False)] if epilogue == "bf16_deq"
                else [(True, True), (False, True)])  # (PReLU, bias)
    for prelu, with_bias in variants:
        x, wt, deq, b, a = _k2_case_inputs(rng, n, h, w, cin, cout, epilogue,
                                           prelu, with_bias, saturate)
        got = _k2_walk(x, wt, deq, b, a, 64.0, pad, epilogue, grid)
        want = int8_conv3x3_requant_plain(x, wt, deq, b, a, 64.0, pad=pad,
                                          epilogue=epilogue)
        assert got.shape == want.shape
        if epilogue == "bf16_deq":  # bit patterns, signed zeros included
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        else:
            assert torch.equal(got, want)


# ----------------------------------------------------------- the int8 chain

def _nets(rng, num_feat, num_conv, upscale):
    """The flax SRVGG with random params (biases and slopes drawn too) and
    the port's net holding the same values."""
    opt = dict(type="SRVGGNetCompact", num_feat=num_feat, num_conv=num_conv,
               upscale=upscale)
    jnet = jax_build(opt)
    params = jnet.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    net = build_network(opt)
    net.load_state_dict(state_dict_from_jax(net, params), strict=True)
    return params, net.eval()


def _calib(rng):
    return rng.random((2, 24, 20, 3)).astype(np.float32)


def test_calibrate_scales_match_jax(rng):
    params, net = _nets(rng, 16, 3, 4)
    x = _calib(rng)
    want = np.asarray(jq.calibrate_srvgg_act_scales(params, jnp.asarray(x),
                                                    3))
    got = tq.calibrate_srvgg_act_scales(net, _t(x)).numpy()
    assert got.shape == want.shape == (3 + 3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _jax_q(params, scales, num_conv):
    return jq.quantize_srvgg_params(params, [float(s) for s in scales],
                                    num_conv, pack=2)


def test_quantize_params_match_jax(rng):
    """Key by key: int8 weights (the port's (Cout, 3, 3, Cin) against JAX's
    HWIO), bf16 deq/b/a with the folded requant scales, inv_last, s_in_0."""
    num_conv = 3
    params, net = _nets(rng, 16, num_conv, 4)
    scales = np.asarray(jq.calibrate_srvgg_act_scales(
        params, jnp.asarray(_calib(rng)), num_conv))
    want = _jax_q(params, scales, num_conv)
    got = tq.quantize_srvgg_params(net, scales.tolist(), pack=2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        v = np.asarray(v)
        if k.startswith("w_"):
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy().transpose(1, 2, 3, 0), v,
                                          err_msg=k)
        else:
            assert str(g.dtype).replace("torch.", "") == str(v.dtype), k
            np.testing.assert_array_equal(g.float().numpy(),
                                          v.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("num_conv,upscale,crop_halo", [
    (2, 2, 0), (4, 4, 0), (3, 4, 3), (2, 2, 2)])
def test_quantized_forward_matches_jax(rng, num_conv, upscale, crop_halo):
    """The int8 chain at pack 2 with the int8 sink, bit for bit, on the
    same q (the port's quantizer, checked equal to JAX's above)."""
    params, net = _nets(rng, 16, num_conv, upscale)
    scales = np.asarray(jq.calibrate_srvgg_act_scales(
        params, jnp.asarray(_calib(rng)), num_conv))
    jqp = _jax_q(params, scales, num_conv)
    q = tq.quantize_srvgg_params(net, scales.tolist(), pack=2)
    x = rng.random((4, 14, 12, 3)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)  # the u8 engine feeds bf16 in [0, 1]
    want = np.asarray(jax.jit(
        lambda q, x: jq.quantized_srvgg_forward(
            q, x, num_conv, upscale, pack=2, crop_halo=crop_halo))(jqp, xb)
        .astype(jnp.float32))
    got = tq.quantized_srvgg_forward(
        q, torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(), num_conv,
        upscale, pack=2, crop_halo=crop_halo)
    assert got.dtype == torch.bfloat16
    c = 2 * crop_halo if crop_halo > 1 else 0
    assert got.shape == (4, (14 - c) * upscale, (12 - c) * upscale, 3)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantized_forward_needs_int8_sink(rng):
    params, net = _nets(rng, 16, 2, 2)
    scales = tq.calibrate_srvgg_act_scales(net, _t(_calib(rng)))
    q = tq.quantize_srvgg_params(net, scales[:-1].tolist(), pack=2)
    assert "inv_last" not in q
    with pytest.raises(NotImplementedError):
        tq.quantized_srvgg_forward(q, torch.zeros(2, 8, 8, 3), 2, 2)
