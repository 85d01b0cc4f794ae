"""The port's dynamic-int8 serving mode against the JAX package on the CPU:
`_int8_conv` (per-tensor dynamic activation scale, per-output-channel
weights, exact int32 sums, bf16 epilogue) bit for bit against JAX's in
every conv form the GFPGAN family uses, `Restorer(quant="dyn-int8")`
against JAX's at the same weights and on the same batch, JAX's serving
gates (tests/test_serve.py:206-217, 349-363), and the flag's scope: a float
and a dyn-int8 restorer interleaved on two threads."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu.ops import modulated_conv as jmc
from image_restoration_tpu_torch.convert import state_dict_from_jax
from image_restoration_tpu_torch.infer import Restorer
from image_restoration_tpu_torch.ops import modulated_conv as tmc

TINY_GFPGAN = dict(type="GFPGANv1OCR", input_width=64, input_height=64,
                   num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
                   input_is_latent=True, different_w=True, narrow=0.5,
                   sft_half=True)
# (Cin, Cout, k, stride, padding, lhs_dilation): the forms that reach
# `_int8_conv` in the GFPGAN family
CASES = {
    "stride1_pad1": (16, 24, 3, 1, 1, 1),
    "stride2_pad0": (16, 24, 3, 2, 0, 1),
    "transposed": (16, 8, 3, 1, 2, 2),
    "valid": (8, 16, 3, 1, 0, 1),
    "cin3_cout3": (3, 3, 3, 1, 1, 1),
    "rgb_1x1": (32, 3, 1, 1, 0, 1),
}


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2))
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_conv_matches_jax(case, dtype):
    """Quantized activations and weights, both scales, the int32 sums and
    the output are equal to JAX's for equal inputs."""
    cin, cout, k, stride, pad, dil = CASES[case]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())  # HWIO → OIHW
    padding = ((pad, pad), (pad, pad))

    xq, sx = jmc._dyn_quant(xj)
    wq, sw = jmc._quant_weight(jnp.asarray(w))
    acc = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), padding,
        lhs_dilation=None if dil == 1 else (dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = jmc._int8_conv(xj, jnp.asarray(w), stride, padding,
                          lhs_dilation=None if dil == 1 else (dil, dil))

    xqt, sxt = tmc._dyn_quant(xt)
    wqt, swt = tmc._quant_weight(wt)
    np.testing.assert_array_equal(xqt.numpy(), np.asarray(xq))
    assert sxt.item() == float(sx)
    np.testing.assert_array_equal(wqt.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(wq))
    np.testing.assert_array_equal(swt.numpy(), np.asarray(sw))
    sums = tmc._int8_conv_sums(xqt, wqt, stride, padding, dil)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(acc))
    got = tmc._int8_conv(xt, wt, stride, padding, dil)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("form", ["conv2d", "conv_transpose2d",
                                  "fused_valid_conv"])
def test_public_convs_under_int8_serving_match_jax(form):
    """The module's entry points in the mode, as the networks call them
    (the transposed conv flips and casts its weight as JAX does), bit-equal
    to JAX's under its `int8_serving`; outside the mode they are float."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    call = {"conv2d": (lambda m, a, b: m.conv2d(a, b, 2, 1)),
            "conv_transpose2d": (lambda m, a, b: m.conv_transpose2d(a, b)),
            "fused_valid_conv": (lambda m, a, b: m.fused_valid_conv(a, b))}[
        form]
    with jmc.int8_serving():
        want = np.asarray(call(jmc, jnp.asarray(x), jnp.asarray(w)))
    with tmc.int8_serving():
        got = call(tmc, torch.from_numpy(x), wt).numpy()
    np.testing.assert_array_equal(got, want)
    float_out = call(tmc, torch.from_numpy(x), wt).numpy()
    assert not np.array_equal(float_out, got)
    np.testing.assert_allclose(float_out, np.asarray(
        call(jmc, jnp.asarray(x), jnp.asarray(w))), rtol=1e-4, atol=1e-4)



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One intra-op thread for this file's CPU work, so it loads the
    machine less while other test files run beside it; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def restorers():
    """JAX float and dyn-int8 Restorers and the port's, at the same
    TINY_GFPGAN weights (flax init plus noise, carried by
    `state_dict_from_jax`)."""
    rng = np.random.default_rng(3)
    jf = JaxRestorer(TINY_GFPGAN)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), jf.variables["params"])
    jf.variables = {"params": params}
    jq = JaxRestorer(TINY_GFPGAN, quant="dyn-int8")
    jq.variables = jf.variables
    tf = Restorer(TINY_GFPGAN, device="cpu")
    tf.net.load_state_dict(state_dict_from_jax(tf.net, params), strict=True)
    tq = Restorer(TINY_GFPGAN, quant="dyn-int8", device="cpu")
    tq.net.load_state_dict(tf.net.state_dict())
    return jf, jq, tf, tq


def test_restorer_dyn_int8_matches_jax(restorers, rng, capsys):
    """On the same batch the port's dyn-int8 departs from JAX's dyn-int8
    less than JAX's dyn-int8 departs from JAX's float32."""
    jf, jq, tf, tq = restorers
    imgs = rng.random((4, 64, 64, 3)).astype(np.float32)
    j_f32, j_int8 = jf.restore_batch(imgs), jq.restore_batch(imgs)
    t_int8 = tq.restore_batch(imgs)
    port_vs_jax = _psnr(t_int8, j_int8)
    jax_int8_vs_f32 = _psnr(j_int8, j_f32)
    with capsys.disabled():
        print(f"\ndyn-int8, TINY_GFPGAN, 4 images of 64²: port vs JAX "
              f"{port_vs_jax:.2f} dB, JAX dyn-int8 vs JAX f32 "
              f"{jax_int8_vs_f32:.2f} dB, port dyn-int8 vs port f32 "
              f"{_psnr(t_int8, tf.restore_batch(imgs)):.2f} dB")
    assert port_vs_jax > jax_int8_vs_f32


def test_restore_batch_u8_dyn_int8_psnr_gate(restorers, rng):
    """JAX's gate (tests/test_serve.py:206-217): the dyn-int8 u8 path
    against the dyn-int8 float path at 30 dB or more."""
    tq = restorers[3]
    u8 = (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    want = tq.restore_batch(u8.astype(np.float32) / 255.0)
    got = tq.restore_batch_u8(u8)
    assert _psnr(got, want) >= 30.0


def test_restorer_dyn_int8_tracks_float(restorers, rng):
    """JAX's gate (tests/test_serve.py:349-363): at random weights the
    dyn-int8 output tracks the float32 one, mean |d| < 8."""
    tf, tq = restorers[2], restorers[3]
    imgs = rng.random((4, 64, 64, 3)).astype(np.float32)
    want, got = tf.restore_batch(imgs), tq.restore_batch(imgs)
    assert got.shape == want.shape == (4, 64, 64, 3)
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.float32) - want.astype(np.float32)).mean()
    assert d < 8.0, f"dyn-int8 diverged: mean|d|={d}"


def test_int8_flag_stays_in_its_thread(restorers, rng):
    """The mode is a ContextVar: a float and a dyn-int8 restorer
    interleaved on two threads each give their own answer every time, and
    a thread outside the mode is float while another is inside it."""
    tf, tq = restorers[2], restorers[3]
    u8 = (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
    want = {"f": tf.restore_batch_u8(u8), "q": tq.restore_batch_u8(u8)}
    assert not np.array_equal(want["f"], want["q"])
    outs = {"f": [], "q": []}
    start = threading.Barrier(2)

    def run(key, r):
        start.wait()
        for _ in range(3):
            outs[key].append(r.restore_batch_u8(u8))

    threads = [threading.Thread(target=run, args=a)
               for a in (("f", tf), ("q", tq))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for key in "fq":
        assert len(outs[key]) == 3
        for o in outs[key]:
            np.testing.assert_array_equal(o, want[key])

    inside, done = threading.Event(), threading.Event()

    def hold():
        with tmc.int8_serving():
            inside.set()
            done.wait(30)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert inside.wait(30)
        np.testing.assert_array_equal(tf.restore_batch_u8(u8), want["f"])
    finally:
        done.set()
        t.join()
