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
