"""Card-only tests of the port's CUDA kernels (marker `cuda`; they skip
without a GPU). This file imports neither jax nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.ops.fused_act import (
    fused_leaky_relu, fused_leaky_relu_plain)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import (the workers must all
    collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bias_lrelu_kernel_matches_plain(cuda_device, dtype):
    """K1 against its plain version on the card: vector path, scalar path
    (C=3), ragged M, no bias. Same f32 arithmetic: f32 to 1e-6, bf16 to
    1 ulp (rtol 2**-7)."""
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)
    for shape in [(3, 17, 19, 32), (771, 48), (5, 7, 3), (64, 512)]:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(shape[-1:]).astype(
            np.float32)).to(cuda_device)
        xt = x.to(cuda_device, dt)
        for bias in (b, None):
            before = fused_leaky_relu.launches
            got = fused_leaky_relu(xt, bias)
            torch.cuda.synchronize()
            assert fused_leaky_relu.launches == before + 1
            want = fused_leaky_relu_plain(xt, bias)
            tol = 1e-6 if dt == torch.float32 else 2 ** -7
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=0)


@pytest.mark.cuda
def test_fused_bias_lrelu_wrapper_rejects_bad_inputs(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    with pytest.raises(TypeError):
        fused_leaky_relu(x.double())
    with pytest.raises(ValueError):
        fused_leaky_relu(x.t())
    with pytest.raises(ValueError):
        fused_leaky_relu(x, torch.zeros(4, device=cuda_device))
    with pytest.raises(ValueError):
        fused_leaky_relu(x, torch.zeros(8))  # bias on the CPU


def _k2_inputs(rng, n, h, w, cin, cout, epilogue, device):
    from image_restoration_tpu_torch.ops.int8_conv import EPILOGUES
    pdt = EPILOGUES[epilogue][1]
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wt = rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8)
    if h > 8 and w > 8 and cin >= 32:
        # sums of 2^22 and more in one corner: the threads holding them take
        # the kernel's scalar epilogue, the others its fast one
        x[:, :5, :6] = 127
        wt[:min(cout, 9)] = 127
    x = torch.from_numpy(x).to(device)
    wt = torch.from_numpy(wt).to(device)
    # acc has a spread of about sqrt(9·Cin)·127²/3: |acc·deq| reaches ~100,
    # so the bf16 epilogue (and f32 at s_out 64) both clip some values
    scale = 100.0 / (np.sqrt(9 * cin) * 127 ** 2 / 3)
    deq = torch.from_numpy(rng.random(cout).astype(np.float32) * scale)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 5)
    a = torch.from_numpy(rng.random(cout).astype(np.float32))
    return x, wt, *(t.to(device, pdt) for t in (deq, b, a))


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout,pad", [
    (2, 37, 45, 6, 128, 1),    # body_0 (Cin padded to 8), ragged tile edges
    (1, 20, 33, 128, 128, 1),  # body layer
    (1, 12, 70, 128, 96, 1),   # conv_last (two out-channel blocks, 64 + 32)
    (3, 17, 19, 10, 24, 0),    # VALID over a pre-padded input; Cout % 8 != 0
    (1, 5, 3, 4, 3, 1),        # one block, scalar stores
    (2, 25, 528, 6, 96, 1),    # served width; 176 tiles: blocks walk across images
    (1, 1, 40, 64, 192, 1),    # H = 1
    (3, 64, 136, 32, 160, 1),  # W not a multiple of 24; 144 tiles
    (1, 9, 30, 128, 192, 1),   # Cin 128, Cout 192: two 128-channel blocks
])
def test_int8_conv3x3_kernel_matches_plain(cuda_device, epilogue, n, h, w,
                                           cin, cout, pad):
    """K2 against its plain version on the card: integer-exact."""
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant, int8_conv3x3_requant_plain)
    rng = np.random.default_rng(cin * 1000 + cout)
    x, wt, deq, b, a = _k2_inputs(rng, n, h, w, cin, cout, epilogue,
                                  cuda_device)
    for alpha in (a, None):
        before = int8_conv3x3_requant.launches
        got = int8_conv3x3_requant(x, wt, deq, b, alpha, 64.0, pad=pad,
                                   epilogue=epilogue)
        torch.cuda.synchronize()
        assert int8_conv3x3_requant.launches == before + 1
        want = int8_conv3x3_requant_plain(x, wt, deq, b, alpha, 64.0,
                                          pad=pad, epilogue=epilogue)
        assert got.shape == want.shape == (n, h + 2 * pad - 2,
                                           w + 2 * pad - 2, cout)
        assert torch.equal(got, want)
        if got.numel() > 1000:  # the clip is exercised
            assert got.abs().max().item() == 127


@pytest.mark.cuda
def test_int8_conv3x3_wrapper_rejects_bad_inputs(cuda_device):
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda_device)
    wt = torch.zeros((16, 3, 3, 16), dtype=torch.int8, device=cuda_device)
    p = torch.ones(16, device=cuda_device)
    with pytest.raises(TypeError):
        int8_conv3x3_requant(x.float(), wt, p, p)
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x.transpose(1, 2), wt, p, p)
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x, wt, p, p.cpu())
    with pytest.raises(ValueError):
        int8_conv3x3_requant(x, wt, p, p, epilogue="f32")  # no s_out
    with pytest.raises(ValueError):  # Cin above the kernel's 192
        int8_conv3x3_requant(
            torch.zeros((1, 8, 8, 200), dtype=torch.int8, device=cuda_device),
            torch.zeros((16, 3, 3, 200), dtype=torch.int8, device=cuda_device),
            p, p)
    flat = torch.zeros(8 * 8 * 32 + 1, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # x not 16-byte aligned (Cin 32: no pad copy)
        int8_conv3x3_requant(flat[1:].view(1, 8, 8, 32),
                             torch.zeros((16, 3, 3, 32), dtype=torch.int8,
                                         device=cuda_device), p, p)


@pytest.mark.cuda
@pytest.mark.parametrize("crop_halo", [0, 3])
def test_int8_chain_on_card_matches_cpu(cuda_device, crop_halo):
    """The int8 SRVGG chain (pack 2, int8 sink) with K2 on the card equals
    the same chain on K2's plain version on the CPU, bit for bit; one K2
    launch per conv."""
    from image_restoration_tpu_torch.ops import quantized_inference as tq
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    from image_restoration_tpu_torch.serve.sr_engine import build_srvgg
    num_conv = 4
    net = build_srvgg(num_feat=16, num_conv=num_conv, upscale=4, seed=3,
                      device="cpu")
    rng = np.random.default_rng(4)
    calib = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
    scales = tq.calibrate_srvgg_act_scales(net, calib)
    q = tq.quantize_srvgg_params(net, scales.tolist(), pack=2)
    x = torch.from_numpy(rng.random((4, 21, 19, 3)).astype(
        np.float32)).bfloat16()
    want = tq.quantized_srvgg_forward(q, x, num_conv, 4, crop_halo=crop_halo)
    before = int8_conv3x3_requant.launches
    got = tq.quantized_srvgg_forward(
        {k: v.to(cuda_device) for k, v in q.items()}, x.to(cuda_device),
        num_conv, 4, crop_halo=crop_halo)
    torch.cuda.synchronize()
    assert int8_conv3x3_requant.launches == before + num_conv + 2
    assert torch.equal(got.cpu(), want)


def _bf16_ulp(v):
    """One bf16 ulp of each value of v (float32)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,bh", [
    (2, 16, 24, 64, 192, 4),   # a widened stage shape, two images
    (1, 16, 48, 32, 160, 8),   # Cout 160: one slice of NT = 160
    (1, 13, 37, 24, 36, 1),    # ragged H, W, Cin (padded to 32) and Cout
    (2, 40, 528, 64, 192, 8),  # two slices of 96; 220 tiles: blocks walk across images
    (3, 64, 136, 32, 160, 8),  # W not a multiple of 24; 144 tiles over 132 blocks
    (1, 1, 528, 32, 160, 1),   # H = 1 at the probe's width
    (1, 9, 30, 128, 192, 1),   # Cin 128: six slices of 32
    (2, 9, 30, 10, 3, 1),      # Cin 10 (padded to 16), odd Cout: scalar stores
])
def test_conv3x3_im2col_kernel_matches_plain(cuda_device, n, h, w, cin, cout,
                                             bh):
    """K3 against its plain version on the card: float32 out within 1e-5 of
    max|plain| (the same products, summed in another order); bf16 out within
    one bf16 ulp of the plain value, plus that float32 tolerance where a sum
    cancels to near zero (its ulp is then below the summation error)."""
    from image_restoration_tpu_torch.ops.im2col_conv import (
        conv3x3_im2col, conv3x3_im2col_plain)
    rng = np.random.default_rng(cin * 100 + cout)
    x = torch.from_numpy(rng.standard_normal((n, h + 2, w + 2, cin)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(
        np.float32) * 0.1).to(cuda_device, torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = conv3x3_im2col.launches
        got = conv3x3_im2col(x, wt, bh=bh, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert conv3x3_im2col.launches == before + 1
        want = conv3x3_im2col_plain(x, wt, bh=bh, out_dtype=out_dtype)
        assert got.shape == want.shape == (n, h, w, cout)
        assert got.dtype == out_dtype
        err = (got.float() - want.float()).abs()
        tol = 1e-5 * want.abs().max().item()
        if out_dtype == torch.float32:
            assert err.max().item() <= tol
        else:
            assert bool((err <= _bf16_ulp(want.float()) + tol).all())


@pytest.mark.cuda
def test_conv3x3_im2col_wrapper_rejects_bad_inputs(cuda_device):
    from image_restoration_tpu_torch.ops.im2col_conv import conv3x3_im2col
    x = torch.zeros((1, 10, 10, 32), dtype=torch.bfloat16, device=cuda_device)
    wt = torch.zeros((3, 3, 32, 64), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        conv3x3_im2col(x.float(), wt.float())  # the kernel takes bf16 only
    with pytest.raises(ValueError):
        conv3x3_im2col(x.transpose(1, 2), wt)  # not contiguous
    with pytest.raises(ValueError):
        conv3x3_im2col(x, wt.cpu())
    with pytest.raises(ValueError):
        conv3x3_im2col(torch.zeros((1, 10, 10, 144), dtype=torch.bfloat16,
                                   device=cuda_device),
                       torch.zeros((3, 3, 144, 8), dtype=torch.bfloat16,
                                   device=cuda_device))  # Cin > 128


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 19, 37, 64, 192), (2, 19, 37, 32, 160), (2, 19, 37, 32, 64),
    (2, 19, 37, 10, 36),
    (1, 1, 528, 64, 192),    # H = 1 at the served width
    (2, 25, 528, 32, 160),   # 176 tiles: blocks walk across images
    (3, 64, 136, 32, 128),   # W not a multiple of 24; 144 tiles
    (1, 9, 30, 128, 192),    # Cin 128: shared memory holds 64 channels a block
])
def test_int8_conv3x3_bf16_deq_matches_plain(cuda_device, n, h, w, cin, cout):
    """K2's bf16_deq epilogue (the int8 RRDB stage conv) against its plain
    version on the card, with and without the bias: bit-equal, signed zeros
    included."""
    from image_restoration_tpu_torch.ops.int8_conv import (
        int8_conv3x3_requant, int8_conv3x3_requant_plain)
    rng = np.random.default_rng(cin + cout + w)
    x, wt, deq, b, _ = _k2_inputs(rng, n, h, w, cin, cout, "bf16_deq",
                                  cuda_device)
    for bias in (b, None):
        before = int8_conv3x3_requant.launches
        got = int8_conv3x3_requant(x, wt, deq, bias, epilogue="bf16_deq")
        torch.cuda.synchronize()
        assert int8_conv3x3_requant.launches == before + 1
        want = int8_conv3x3_requant_plain(x, wt, deq, bias,
                                          epilogue="bf16_deq")
        assert got.dtype == want.dtype == torch.bfloat16
        assert got.shape == want.shape == (n, h, w, cout)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_int8_rrdb_forward_on_card(cuda_device):
    """One int8 RRDB forward at num_block 1 on the card: 15 K2 launches (3
    dense blocks × 5 stages), and equal bit for bit to the same chain on
    K2's plain version on the card."""
    from unittest import mock
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.ops import int8_conv
    from image_restoration_tpu_torch.ops import rrdb_quant as rq
    net = build_network(dict(type="RRDBNet", num_feat=64, num_block=1,
                             num_grow_ch=32, scale=4),
                        torch.Generator().manual_seed(2)).to(cuda_device)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((2, 24, 20, 3)).astype(np.float32)).to(
        cuda_device)
    q = rq.quantize_rrdb_params(net, rq.calibrate_rrdb_act_scales(net, x))
    before = int8_conv.int8_conv3x3_requant.launches
    got = rq.quantized_rrdb_forward(q, x, 1)
    torch.cuda.synchronize()
    assert int8_conv.int8_conv3x3_requant.launches == before + 15
    with mock.patch.object(rq, "int8_conv3x3_requant",
                           int8_conv.int8_conv3x3_requant_plain):
        want = rq.quantized_rrdb_forward(q, x, 1)
    assert got.shape == (2, 96, 80, 3) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want)
