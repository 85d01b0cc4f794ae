"""The port's int8 RRDB chain against the JAX package
(`image_restoration_tpu/ops/rrdb_quant.py`): calibration, the quantized
weights, kernel K2's "bf16_deq" epilogue (plain version), its RRDB stage op
against that epilogue and the chain's glue (`rrdb_glue.py`) and
`quantized_rrdb_forward`, at num_feat 64 / grow 32 (the widths the chain
takes), 2 blocks. Integer and bf16 results agree exactly unless a test says
which op differs and bounds it."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.ops import rrdb_quant as jq
from image_restoration_tpu.ops import rrdb_widened as jwide
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.ops import packed_inference as tpacked
from image_restoration_tpu_torch.ops import rrdb_quant as tq
from image_restoration_tpu_torch.ops.int8_conv import (
    int8_conv3x3_requant, int8_conv3x3_requant_plain,
    int8_conv3x3_rrdb_stage, int8_conv3x3_rrdb_stage_plain)
from rrdb_glue import VARIANTS, dense_case, glue_stages, run_stages


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NB = 2
OPT = dict(type="RRDBNet", num_feat=64, num_grow_ch=32, num_block=NB, scale=4)
DN = ("NHWC", "HWIO", "NHWC")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def nets():
    """The flax RRDBNet's params, the port's net on the same values, and a
    smooth 24² input pair (as `tests/test_quantized_inference.py:70-99`)."""
    rng = np.random.default_rng(0)
    base = rng.random((2, 6, 6, 3)).astype(np.float32)
    x = np.repeat(np.repeat(base, 4, 1), 4, 2)
    jnet = jax_build(OPT)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    net = build_network(OPT)
    net.load_state_dict(state_dict_from_jax(net, params), strict=True)
    scales = np.asarray(jq.calibrate_rrdb_act_scales(params, jnp.asarray(x),
                                                     NB))
    return jnet, params, net.eval(), x, scales


def test_calibrate_scales_match_jax(nets):
    _, _, net, x, want = nets
    got = tq.calibrate_rrdb_act_scales(net, _t(x)).numpy()
    assert got.shape == want.shape == (NB, 3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_quantize_params_match_jax(nets):
    """int8 weights equal (the port's (Cout, 3, 3, Cin) against JAX's HWIO),
    deq and b equal in bf16, rin_t equal; head and tail bf16 equal."""
    _, params, net, _, scales = nets
    want = jq.quantize_rrdb_params(params, scales, NB)
    got = tq.quantize_rrdb_params(net, scales)
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                 "conv_hr", "conv_last"):
        w, b = got[name]
        assert w.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            w.float().numpy().transpose(2, 3, 1, 0),
            np.asarray(want[name][0], np.float32), err_msg=name)
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(want[name][1], np.float32))
    for rdb in ("rdb1", "rdb2", "rdb3"):
        assert sorted(got["blocks"][rdb]) == sorted(want["blocks"][rdb])
        for k, v in want["blocks"][rdb].items():
            g, v = got["blocks"][rdb][k], np.asarray(v)
            if k.startswith("w"):
                assert g.dtype == torch.int8
                np.testing.assert_array_equal(
                    g.numpy().transpose(0, 2, 3, 4, 1), v, err_msg=k)
            else:
                assert g.dtype == torch.bfloat16 and g.shape == v.shape, k
                np.testing.assert_array_equal(g.float().numpy(),
                                              v.astype(np.float32),
                                              err_msg=f"{rdb}.{k}")


@pytest.mark.parametrize("cin,cout", [(64, 192), (32, 160), (32, 64)])
def test_bf16_deq_plain_matches_jax_stage(rng, cin, cout):
    """K2's "bf16_deq" epilogue against `jax.jit` of the JAX chain's stage
    expression (`rrdb_quant.py:153-169`): `acc.astype(bf16) · deq (+ b)`,
    bit for bit, with and without the bias."""
    x = rng.integers(-127, 128, (2, 10, 13, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    deq = jnp.asarray(rng.random(cout) * 1e-4, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(cout), jnp.bfloat16)

    @jax.jit
    def stage(t, w, deq, b):
        acc = jax.lax.conv_general_dilated(
            t, w, (1, 1), ((1, 1), (1, 1)), dimension_numbers=DN,
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.bfloat16) * deq
        return y if b is None else y + b

    def bf(v):
        return torch.from_numpy(np.asarray(v, np.float32)).bfloat16()

    for bias in (b, None):
        want = np.asarray(stage(jnp.asarray(x), jnp.asarray(wt), deq, bias),
                          np.float32)
        for fn in (int8_conv3x3_requant_plain, int8_conv3x3_requant):
            got = fn(_t(x), _t(wt.transpose(3, 0, 1, 2)), bf(deq),
                     None if bias is None else bf(bias), epilogue="bf16_deq")
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_deq_checks():
    x = torch.zeros((1, 5, 5, 8), dtype=torch.int8)
    w = torch.zeros((4, 3, 3, 8), dtype=torch.int8)
    p = torch.ones(4)
    with pytest.raises(ValueError, match="no activation"):
        int8_conv3x3_requant(x, w, p, None, p, epilogue="bf16_deq")
    with pytest.raises(ValueError, match="needs a bias"):
        int8_conv3x3_requant(x, w, p, None, epilogue="bf16")
    assert int8_conv3x3_requant(x, w, p, None, epilogue="bf16_deq").dtype \
        == torch.bfloat16


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rrdb_stage_plain_matches_glue(variant):
    """The RRDB stage op's plain version (called directly and through
    ``irt::int8_conv3x3_rrdb_stage``), run over stages 0 … s of one dense
    block on random int8 inputs, against K2's "bf16_deq" epilogue followed
    by the chain's glue op by op: stage s's outputs and the slice sums P
    bit for bit, signed zeros included. Variants: each stage, stage 4 with
    the block carry, and the network's last dense block (carry, no next
    input). Some sums pass 2^22 (`dense_case`)."""
    case = dense_case(2, 9, 11, 11 + len(variant), "cpu")
    want, want_p = glue_stages(case, variant)
    for op in (int8_conv3x3_rrdb_stage_plain, int8_conv3x3_rrdb_stage):
        got, p = run_stages(op, case, variant)
        assert [g.dtype for g in got] == [w.dtype for w in want]
        for g, w in zip(got + [p], want + [want_p]):
            assert g.shape == w.shape
            if g.dtype == torch.bfloat16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            assert torch.equal(g, w)
    # the case reaches LeakyReLU's negative side and the int8 clip
    if VARIANTS[variant][0] < 4:
        assert got[0].min().item() < 0 and got[0].max().item() == 127


def test_rrdb_stage_checks():
    x = torch.zeros((1, 5, 5, 32), dtype=torch.int8)
    w = torch.zeros((64, 3, 3, 32), dtype=torch.int8)
    d = torch.ones(64, dtype=torch.bfloat16)
    p = torch.zeros((1, 5, 5, 160), dtype=torch.bfloat16)
    t = torch.zeros((1, 5, 5, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs the residual"):
        int8_conv3x3_rrdb_stage(x, w, d, None, p, stage=4)
    with pytest.raises(ValueError, match="stage 4's"):
        int8_conv3x3_rrdb_stage(x, w, d, None, p, t, stage=3)
    with pytest.raises(ValueError, match="stage must be"):
        int8_conv3x3_rrdb_stage(x, w, d, None, p, stage=5)
    with pytest.raises(ValueError, match="does not fit"):
        int8_conv3x3_rrdb_stage(x, w, d, None, p[..., :32], stage=1)
    with pytest.raises(ValueError, match="p must be"):
        int8_conv3x3_rrdb_stage(x, w, d, None, p.float(), stage=1)
    q, y = int8_conv3x3_rrdb_stage(x, w, d, None, p, t, stage=4)
    assert q is None  # no rin: the network's last dense block
    assert y.dtype == torch.bfloat16 and y.shape == (1, 5, 5, 64)
    q, y = int8_conv3x3_rrdb_stage(x, w, d, None, p, stage=1)
    assert y is None and q.dtype == torch.int8 and q.shape == (1, 5, 5, 32)


def _xla_conv(t, w, b=None):
    """The chain's bf16 head/tail conv computed by XLA (`rrdb_widened.py`
    `_conv`), on the port's tensors."""
    y = jax.jit(jwide._conv)(
        jnp.asarray(t.float().numpy(), jnp.bfloat16),
        jnp.asarray(w.float().numpy().transpose(2, 3, 1, 0), jnp.bfloat16),
        None if b is None else jnp.asarray(b.float().numpy(), jnp.bfloat16))
    return torch.from_numpy(np.asarray(y, np.float32)).bfloat16()


def _jax_stage_inputs(q, x):
    """The int8 input of every stage conv of the JAX chain, in order (the
    forward run op by op, with its int8 conv wrapped)."""
    seen = []
    conv_i8 = jq._conv_i8

    def record(t, w):
        seen.append(np.asarray(t))
        return conv_i8(t, w)

    with mock.patch.object(jq, "_conv_i8", record), jax.disable_jit():
        jq.quantized_rrdb_forward(q, jnp.asarray(x), NB)
    return seen


def test_quantized_forward_matches_jax(nets):
    """The int8 chain at num_feat 64, 2 blocks, 24²: every int8 stage input
    equal and the bf16 output bit-equal to `jax.jit(quantized_rrdb_forward)`
    on the same weights, the stage inputs recorded at the RRDB stage op's
    calls. One op is taken from XLA: the six bf16 head/tail
    convs, whose float32 sums PyTorch's CPU conv orders differently (see the
    next test for the port's own convs)."""
    _, params, net, x, scales = nets
    jqp = jq.quantize_rrdb_params(params, scales, NB)
    want = np.asarray(jax.jit(lambda q, x: jq.quantized_rrdb_forward(
        q, x, NB))(jqp, jnp.asarray(x)), np.float32)
    want_inputs = _jax_stage_inputs(jqp, x)
    assert len(want_inputs) == NB * 3 * 5

    q = tq.quantize_rrdb_params(net, scales)
    seen = []

    def record(t, *a, **k):
        seen.append(t.numpy())
        return int8_conv3x3_rrdb_stage(t, *a, **k)

    with mock.patch.object(tq, "conv_nhwc", _xla_conv), \
            mock.patch.object(tpacked, "conv_nhwc", _xla_conv), \
            mock.patch.object(tq, "int8_conv3x3_rrdb_stage", record):
        got = tq.quantized_rrdb_forward(q, _t(x), NB)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 96, 96, 3)
    assert len(seen) == len(want_inputs)
    for i, (a, b) in enumerate(zip(seen, want_inputs)):
        np.testing.assert_array_equal(a, b, err_msg=f"stage input {i}")
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantized_forward_own_convs_close_to_jax(nets):
    """With its own CPU convs the port's chain differs from JAX's only
    where a head/tail conv's float32 sum rounds to the other bf16 neighbour
    and that flip propagates. Measured: 2.37% of values differ, the largest
    by half a bf16 ulp of max|ref|, 80.2 dB span-normalized PSNR. Held to
    ≤ 2.5% of values, none by more than one bf16 ulp of max|ref|, ≥ 75 dB."""
    _, params, net, x, scales = nets
    want = np.asarray(jax.jit(lambda q, x: jq.quantized_rrdb_forward(
        q, x, NB))(jq.quantize_rrdb_params(params, scales, NB),
                   jnp.asarray(x)), np.float32)
    got = tq.quantized_rrdb_forward(tq.quantize_rrdb_params(net, scales),
                                    _t(x), NB).float().numpy()
    d = np.abs(got - want)
    assert (d > 0).mean() <= 0.025
    assert d.max() <= 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    mse = float(np.mean(d ** 2))
    span = float(want.max() - want.min())
    assert 10 * np.log10(span ** 2 / mse) >= 75.0


def test_quantized_forward_close_to_f32(nets):
    """The int8 chain against the plain float32 forward: ≥ 35 dB
    span-normalized PSNR, the JAX package's gate
    (`tests/test_quantized_inference.py:70-99`)."""
    _, _, net, x, _ = nets
    q = tq.quantize_rrdb_params(net, tq.calibrate_rrdb_act_scales(net, _t(x)))
    got = tq.quantized_rrdb_forward(q, _t(x), NB).float().numpy()
    with torch.no_grad():
        want = net(_t(x)).numpy()
    mse = float(np.mean((got - want) ** 2))
    span = float(want.max() - want.min()) or 1.0
    assert 10 * np.log10(span ** 2 / max(mse, 1e-12)) >= 35.0
    with pytest.raises(ValueError):
        tq.quantized_rrdb_forward(q, _t(x), NB, scale=2)
