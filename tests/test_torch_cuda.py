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


@pytest.fixture
def no_tf32():
    """float32 convs and matmuls in full float32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bias_lrelu_grads_match_plain(cuda_device, dtype):
    """With grad on, K1's output carries a grad_fn (the launch still
    happens, once); its grads, and the double backward, equal autograd of
    the plain version on the card. Under inference_mode it launches the
    same once and records nothing."""
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    x0 = torch.from_numpy(rng.standard_normal((6, 9, 32)).astype(
        np.float32)).to(cuda_device, dt)
    b0 = torch.from_numpy(rng.standard_normal(32).astype(np.float32)).to(
        cuda_device)
    g = torch.from_numpy(rng.standard_normal((6, 9, 32)).astype(
        np.float32)).to(cuda_device, dt).requires_grad_()
    u = torch.from_numpy(rng.standard_normal((6, 9, 32)).astype(
        np.float32)).to(cuda_device, dt)
    res = {}
    for name, fn in (("kernel", fused_leaky_relu),
                     ("plain", fused_leaky_relu_plain)):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        before = fused_leaky_relu.launches
        y = fn(x, b)
        assert y.grad_fn is not None
        assert fused_leaky_relu.launches == before + (name == "kernel")
        gx, gb = torch.autograd.grad(y, (x, b), g, create_graph=True)
        gg = torch.autograd.grad((gx.float() * u.float()).sum(), g)[0]
        res[name] = (y, gx, gb, gg)
    tol = dict(rtol=1e-6, atol=0) if dt == torch.float32 else \
        dict(rtol=2 ** -7, atol=0)
    for a, w in zip(res["kernel"], res["plain"]):
        torch.testing.assert_close(a.float(), w.float(), **tol)
    with torch.inference_mode():
        before = fused_leaky_relu.launches
        y = fused_leaky_relu(x0, b0)
        assert fused_leaky_relu.launches == before + 1 and y.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["Resnet18", "mobilenet0.25"])
def test_retinaface_and_nms_on_card_match_cpu(cuda_device, no_tf32,
                                              backbone):
    """RetinaFace at 224² on the card against the CPU (TF32 off), and the
    detector's NMS on the card's outputs against the CPU's NMS on the same
    boxes: keep and order equal."""
    from image_restoration_tpu_torch.detect.engine import PlateDetector
    kw = dict(backbone=backbone, image_size=224, score_threshold=0.0,
              keep_top_k=20, seed=3)
    cpu = PlateDetector(device="cpu", **kw)
    gpu = PlateDetector(device=cuda_device, **kw)
    x = torch.from_numpy((np.random.default_rng(2).random(
        (2, 224, 224, 3)) * 255).astype(np.float32))
    with torch.no_grad():
        want = cpu.net(x - cpu._mean)
        got = gpu.net(x.to(cuda_device) - gpu._mean)
    for w, a in zip(want, got):
        scale = max(1.0, w.abs().max().item())
        assert (a.cpu() - w).abs().max().item() <= 1e-3 * scale
    from image_restoration_tpu_torch.detect.box_utils import decode, nms
    boxes = decode(got[0], gpu.priors, gpu.cfg["variance"])
    kb, ks, keep, order = nms(boxes, got[1][..., 1], 0.6, 200, 0.0)
    kb_c, ks_c, keep_c, order_c = nms(boxes.cpu(), got[1][..., 1].cpu(),
                                      0.6, 200, 0.0)
    assert torch.equal(order.cpu(), order_c)
    assert torch.equal(keep.cpu(), keep_c)
    assert torch.equal(kb.cpu(), kb_c) and torch.equal(ks.cpu(), ks_c)


@pytest.mark.cuda
def test_geometry_on_card_matches_cpu(cuda_device):
    """The geometry ops on the card against the CPU: masks equal, values
    within 1e-4 of the 0–255 range."""
    from image_restoration_tpu_torch.ops import geometry as tg
    rng = np.random.default_rng(4)
    quads = np.array([[[40, 90], [200, 80], [210, 160], [30, 170]],
                      [[10, 10], [120, 120], [120, 10], [10, 120]],
                      [[16, 255], [16, 255], [255, 0], [0, 150]]],
                     np.float32)
    img = torch.from_numpy((rng.random((3, 256, 256, 6)) * 255).astype(
        np.float32))
    q = torch.from_numpy(quads)
    outs = {}
    for dev in ("cpu", cuda_device):
        qd, imd = q.to(dev), img.to(dev)
        m = tg.homography_square_to_quad(256.0, qd)
        m = torch.where(torch.isfinite(m).all(-1).all(-1)[:, None, None]
                        & (tg.det3x3(m).abs() > 1e-8)[:, None, None],
                        m, torch.eye(3, device=dev))
        bbox = tg.bbox_of_quad(qd, (256, 256))
        outs[str(dev)] = [t.cpu() for t in (
            tg.quad_mask(qd, (256, 256)), tg.quad_mask_aa(qd, (256, 256)),
            m, tg.warp_perspective(imd, m),
            tg.crop_resize(imd, bbox, (256, 256)),
            tg.pad_resize(imd, bbox, (256, 256)))]
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    assert torch.equal(cpu[0], gpu[0]) and torch.equal(cpu[1], gpu[1])
    torch.testing.assert_close(gpu[2], cpu[2], rtol=1e-5, atol=1e-6)
    for a, w in zip(gpu[3:], cpu[3:]):
        assert (a - w).abs().max().item() <= 1e-4 * 255


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k,stride,pad,dil", [
    (16, 24, 3, 1, 1, 1), (16, 24, 3, 2, 0, 1), (16, 8, 3, 1, 2, 2),
    (3, 3, 3, 1, 1, 1), (512, 512, 3, 1, 1, 1)])
def test_dyn_int8_conv_on_card_matches_cpu(cuda_device, cin, cout, k,
                                           stride, pad, dil):
    """The dynamic-int8 conv on the card (`torch._int_mm` through cuBLASLt,
    M padded to 32 for a 4² map at batch 1) against the CPU: quantized
    activations, int32 sums and the bf16-epilogue output equal."""
    from image_restoration_tpu_torch.ops import modulated_conv as mc
    rng = np.random.default_rng(9)
    hw = 4 if cin == 512 else 9
    x = torch.from_numpy(rng.standard_normal((1, hw, hw, cin)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((cout, cin, k, k)) * 0.05)
                         .astype(np.float32))
    padding = ((pad, pad), (pad, pad))
    outs = {}
    for dev in ("cpu", cuda_device):
        xq, sx = mc._dyn_quant(x.to(dev))
        wq, _ = mc._quant_weight(w.to(dev))
        outs[str(dev)] = [t.cpu() for t in (
            xq, sx, mc._int8_conv_sums(xq, wq, stride, padding, dil),
            mc._int8_conv(x.to(dev), w.to(dev), stride, padding, dil))]
    for a, b in zip(outs[str(cuda_device)], outs["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_exported_kernel_ops_launch_on_card(cuda_device, tmp_path):
    """K1, K2 and K3 as `irt::` ops in a torch.export program on the card:
    saved, loaded, run; each kernel launches once per call of the loaded
    program and the result equals the eager call's."""
    from image_restoration_tpu_torch.ops.im2col_conv import conv3x3_im2col
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    from image_restoration_tpu_torch.serve.engine_restorer import (
        export_graph, load_engine, save_engine)
    g = torch.Generator().manual_seed(0)
    w8 = torch.randint(-127, 128, (32, 3, 3, 32), dtype=torch.int8,
                       generator=g).to(cuda_device)
    deq = (torch.rand(32, generator=g) * 1e-3).to(cuda_device)
    bias = torch.rand(32, generator=g).to(cuda_device)
    wk3 = torch.randn(3, 3, 32, 16, generator=g).to(cuda_device,
                                                   torch.bfloat16)

    def graph(x8):
        y = int8_conv3x3_requant(x8, w8, deq, bias, None, pad=1,
                                 epilogue="bf16_deq")
        y = fused_leaky_relu(y.contiguous(), bias.to(y.dtype))
        return conv3x3_im2col(torch.nn.functional.pad(
            y, (0, 0, 1, 1, 1, 1)).contiguous(), wk3, out_dtype=torch.float32)

    x8 = torch.randint(-127, 128, (2, 16, 24, 32), dtype=torch.int8,
                       generator=g).to(cuda_device)
    program = export_graph(graph, (x8,))
    names = {str(n.target) for n in program.graph.nodes}
    assert {"irt.int8_conv3x3_requant.default", "irt.fused_bias_lrelu.default",
            "irt.conv3x3_im2col.default"} <= names
    save_engine(str(tmp_path), program, {"device": str(cuda_device)})
    module, _ = load_engine(str(tmp_path), cuda_device)
    kernels = (int8_conv3x3_requant, fused_leaky_relu, conv3x3_im2col)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        got = module(x8)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
        assert torch.equal(got, graph(x8))


# ------------------------------------------------ the GFPGAN trainer

def _tiny_gan_opt(tmp_path):
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "model_type": "GFPGANModel",
            "path": {"models": str(tmp_path / "m")},
            "network_g": dict(type="GFPGANv1OCR", input_width=64,
                              input_height=64, num_style_feat=32,
                              channel_multiplier=0.5, num_mlp=2,
                              input_is_latent=True, different_w=True,
                              narrow=0.5, sft_half=True),
            "network_d": dict(type="StyleGAN2Discriminator",
                              input_width=64, input_height=64,
                              channel_multiplier=0.5, narrow=0.5),
            "train": {"optim_g": {"type": "Adam", "lr": 2e-3},
                      "optim_d": {"type": "Adam", "lr": 2e-3},
                      "L1_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 0.1},
                      "gan_opt": {"type": "GANLoss",
                                  "gan_type": "wgan_softplus",
                                  "loss_weight": 0.1},
                      "net_d_reg_every": 16, "r1_reg_weight": 10}}


@pytest.mark.cuda
def test_gan_d_and_r1_steps_kernel_match_plain(cuda_device, no_tf32,
                                               tmp_path):
    """The D logistic loss and the R1 penalty (a double backward through
    K1's autograd formula) with K1's kernel against the same with K1's
    plain version: losses within 1e-5 relative, D gradients within 1e-4 of
    max|grad|; K1 launches 11 per D forward at 64² (1 + 2 for each of 4
    ResBlocks + final conv + final linear) and none in the double
    backward."""
    from unittest import mock
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.ops import fused_act
    model = build_model(_tiny_gan_opt(tmp_path), device=cuda_device)
    g = torch.Generator().manual_seed(1)
    fake = (torch.rand((4, 64, 64, 3), generator=g) * 2 - 1).to(cuda_device)
    gt = (torch.rand((4, 64, 64, 3), generator=g) * 2 - 1).to(cuda_device)

    def run():
        model.net_d.zero_grad()
        l_d, _, _ = model.d_loss(fake, gt)
        l_d.backward()
        gd = [p.grad.clone() for p in model.net_d.parameters()]
        model.net_d.zero_grad()
        l_r1 = model.r1_loss(gt)
        l_r1.backward()
        gr = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
              for p in model.net_d.parameters()]
        return l_d.item(), l_r1.item(), gd, gr

    fused_act.fused_leaky_relu.launches = 0
    k = run()
    assert fused_act.fused_leaky_relu.launches == 3 * 11
    with mock.patch.object(fused_act, "fused_leaky_relu",
                           fused_act.fused_leaky_relu_plain):
        p = run()
    for a, b in zip(k[:2], p[:2]):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    for ga, gb in zip(k[2] + k[3], p[2] + p[3]):
        scale = max(float(gb.abs().max()), 1e-12)
        assert float((ga - gb).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["kernel", "median", "bilateral",
                                   "noise", "jpeg", "down_up", "jitter",
                                   "jitter_pt", "gray", "chain"])
def test_degradation_apply_on_card_matches_cpu(cuda_device, no_tf32, stage):
    """Each apply half of the production chain at the same drawn
    parameters on the card and on the CPU: median's 8-bit levels bit-equal
    (its values within an ulp: the card divides by 255 as a multiply by the
    reciprocal); the float ops
    within 1e-5; JPEG and the whole chain (which round DCT coefficients
    and quantize to uint8) within 2/255 on ≥99% of values: two 8-bit levels
    for JPEG, one for the chain, whose output is normalized by
    (x − 0.5)/0.5."""
    from image_restoration_tpu_torch.data import degradations as D
    from image_restoration_tpu_torch.data import pipelines as P
    deg = P.make_ffhq_degradation(P.FFHQDegradationConfig())
    g = torch.Generator().manual_seed(2)
    gt = torch.rand((4, 64, 64, 3), generator=g)
    p = deg.sample(g, 4, 64, 64)
    cfg = deg.cfg

    def apply(x, q, dev):
        if stage == "kernel":
            return D.filter2d(x, D.mixed_kernel(q["kernel"], cfg.kernel_list,
                                                21, deg.bank(dev)))
        if stage == "median":
            return D.median_blur(x, 15)
        if stage == "bilateral":
            return D.bilateral_blur(x, 15, q["bilateral_sigma"],
                                    q["bilateral_sigma"])
        if stage == "noise":
            return D.add_gaussian_noise(x[:, :16, :16], q["noise"])
        if stage == "jpeg":
            return D.add_jpeg_compression(x, q["jpeg_quality"])
        if stage == "down_up":
            return D.random_down_up(x, q["down_scale"])[0]
        if stage == "jitter":
            return D.color_jitter(x, q["jitter"])
        if stage == "jitter_pt":
            return D.color_jitter_pt(x, q["jitter_pt"])
        if stage == "gray":
            return D.random_grayscale(x, torch.ones_like(q["gray"]))
        return torch.cat(deg.apply(x, q), dim=-1)

    if stage == "median":
        gt = torch.round(gt * 255) / 255
    want = apply(gt, p, torch.device("cpu"))
    got = apply(gt.to(cuda_device), D.params_to(p, cuda_device),
                cuda_device).cpu()
    d = (got - want).abs()
    if stage == "median":  # the levels; /255 on the card is ×(1/255)
        assert torch.equal(torch.round(got * 255), torch.round(want * 255))
        assert float(d.max()) <= 1e-7
    elif stage in ("jpeg", "chain"):
        assert float((d <= 2 / 255 + 1e-6).float().mean()) >= 0.99
    else:
        assert float(d.max()) <= 1e-5, float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["blur", "rescale", "noise", "final",
                                   "chain"])
def test_realesrgan_apply_on_card_matches_cpu(cuda_device, no_tf32, stage):
    """Each stage of the Real-ESRGAN chain, and the chain, at the same drawn
    parameters (Poisson counts drawn on the CPU and replayed) on the card
    and on the CPU: float stages within 1e-5; the final stage (JPEG) and
    the chain within 2/255 on ≥99% of values."""
    from image_restoration_tpu_torch.data import degradations as D
    from image_restoration_tpu_torch.data import pipelines as P
    cfg = P.RealESRGANDegradationConfig()
    deg = P.make_realesrgan_degradation(cfg)
    g = torch.Generator().manual_seed(3)
    gt = torch.rand((4, 64, 64, 3), generator=g)
    p = deg.sample(g, 4, 64, 64)

    def apply(x, q):
        if stage == "blur":
            return deg.blur_stage(x, q["blur1"], cfg.kernel_list)
        if stage == "rescale":
            return P.virtual_rescale(x, q["resize1"])
        if stage == "noise":
            return deg.noise_stage(x, q["noise1"], g)
        if stage == "final":
            return deg.final_stage(x, q)
        return deg.apply(x, q, g)[0]

    want = apply(gt, p)  # the CPU first: it draws the Poisson counts
    got = apply(gt.to(cuda_device), D.params_to(p, cuda_device)).cpu()
    d = (got - want).abs()
    if stage in ("final", "chain"):
        assert float((d <= 2 / 255 + 1e-6).float().mean()) >= 0.99
    else:
        assert float(d.max()) <= 1e-5, float(d.max())


@pytest.mark.cuda
def test_qat_checkpoint_engine_on_card(cuda_device, tmp_path):
    """The int8 engine built from a QAT checkpoint on the card: one K2
    launch per int8 conv, bit-equal to the same engine on the CPU (K2's
    plain version), and to the trained model's `export_quantized`."""
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.ops import quantized_inference as tq
    from image_restoration_tpu_torch.ops.int8_conv import int8_conv3x3_requant
    from image_restoration_tpu_torch.serve.sr_engine import build_graph
    num_conv = 4
    opt = {"is_train": True, "manual_seed": 0, "model_type": "SRModel",
           "path": {"models": str(tmp_path)},
           "network_g": {"type": "SRVGGNetCompact", "num_feat": 16,
                         "num_conv": num_conv, "upscale": 4},
           "train": {"optim_g": {"type": "Adam", "lr": 1e-3},
                     "pixel_opt": {"type": "L1Loss"}, "quant_opt": {}}}
    model = build_model(opt, device="cpu")
    rng = np.random.default_rng(5)
    model.optimize_parameters(1, {
        "lq": rng.random((2, 16, 16, 3)).astype(np.float32),
        "gt": rng.random((2, 64, 64, 3)).astype(np.float32)})
    ckpt = model.save(1)
    kw = dict(num_feat=16, num_conv=num_conv, upscale=4, tile=16, halo=2,
              batch=2, io="bf16", qat_ckpt=ckpt)
    cpu_graph, _ = build_graph(device="cpu", **kw)
    card_graph, meta = build_graph(device=cuda_device, **kw)
    assert meta["qat"]
    x = torch.from_numpy(rng.random((2, 20, 20, 3)).astype(
        np.float32)).bfloat16()
    with torch.inference_mode():
        want = cpu_graph(x)
        before = int8_conv3x3_requant.launches
        got = card_graph(x.to(cuda_device))
        torch.cuda.synchronize()
    assert int8_conv3x3_requant.launches == before + num_conv + 2
    assert torch.equal(got.cpu(), want)
    ref = tq.quantized_srvgg_forward(model.export_quantized(), x, num_conv,
                                     4)
    assert torch.equal(want, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["SRModel", "ESRGANModel"])
def test_sr_trainer_step_on_card_matches_cpu(cuda_device, no_tf32, tmp_path,
                                             model_type):
    """One step of an SR trainer (QAT SRVGG; ESRGAN with the VGG-style D)
    on the card and on the CPU from the same weights and batch, with SGD
    (Adam's first step turns a gradient within float rounding of 0 into a
    step of up to lr): losses within 1e-5 relative, parameters after the
    step within 1e-5 of max|p|, D's running statistics (refreshed by the
    updated D) within 1e-4."""
    from image_restoration_tpu_torch.models import build_model
    sgd = {"type": "SGD", "lr": 1e-3}
    train = {"optim_g": sgd, "pixel_opt": {"type": "L1Loss"}}
    opt = {"is_train": True, "manual_seed": 0, "model_type": model_type,
           "path": {"models": str(tmp_path)}, "train": train}
    if model_type == "SRModel":
        opt["network_g"] = {"type": "SRVGGNetCompact", "num_feat": 8,
                            "num_conv": 2, "upscale": 4}
        train["quant_opt"] = {}
        n, hw = 2, 16
    else:
        opt["network_g"] = {"type": "RRDBNet", "num_feat": 8,
                            "num_block": 1, "num_grow_ch": 4}
        opt["network_d"] = {"type": "VGGStyleDiscriminator128",
                            "num_feat": 4}
        train.update(optim_d=sgd,
                     gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                              "loss_weight": 5e-3})
        n, hw = 4, 32
    cpu = build_model(opt, device="cpu")
    card = build_model(opt, device=cuda_device)
    for name in ("net_g", "net_g_ema", "net_d"):
        if hasattr(cpu, name):
            getattr(card, name).load_state_dict(
                getattr(cpu, name).state_dict())
    g = torch.Generator().manual_seed(6)
    batch = {"lq": torch.rand((n, hw, hw, 3), generator=g),
             "gt": torch.rand((n, 4 * hw, 4 * hw, 3), generator=g)}
    want = cpu.optimize_parameters(1, batch)
    got = card.optimize_parameters(1, batch)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    for name in ("net_g", "net_d"):
        if not hasattr(cpu, name):
            continue
        want_sd = getattr(cpu, name).state_dict()
        got_sd = getattr(card, name).state_dict()
        scale = max(float(v.abs().max()) for k, v in want_sd.items()
                    if "running" not in k)
        for k, v in want_sd.items():
            d = float((got_sd[k].cpu().float() - v.float()).abs().max())
            assert d <= (1e-4 if "running" in k else 1e-5 * scale), k


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["up", "down"])
def test_fused_resample_on_card_matches_cpu(cuda_device, no_tf32, op):
    """`conv_up_fir` / `conv_down_fir` on the card against the CPU (TF32
    off): within 1e-5 of max|CPU|."""
    from image_restoration_tpu_torch.ops import fused_resample
    fn = getattr(fused_resample, f"conv_{op}_fir")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, 24, 32), generator=g)
    w = torch.randn((48, 32, 3, 3), generator=g) / 17
    want = fn(x, w)
    got = fn(x.to(cuda_device), w.to(cuda_device)).cpu()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_stylegan2_path_step_kernel_matches_plain(cuda_device, no_tf32,
                                                  tmp_path):
    """StyleGAN2Model's path-length penalty (a double backward through the
    generator and K1's autograd formula) with K1's kernel against the same
    with K1's plain version, two codes mixed at index 3: the penalty within
    1e-5 relative, G gradients within 1e-4 of max|grad|; K1 launches
    2·2 + 7 in the forward (two codes through the 2-layer MLP, 7
    StyleConvs at 32²) and none in the double backward."""
    from unittest import mock
    from image_restoration_tpu_torch.models import build_model
    from image_restoration_tpu_torch.ops import fused_act
    g_opt = dict(type="StyleGAN2Generator", out_size=32, num_style_feat=16,
                 num_mlp=2, channel_multiplier=0.25, narrow=0.125)
    d_opt = dict(type="StyleGAN2Discriminator", out_size=32,
                 channel_multiplier=0.25, narrow=0.125)
    model = build_model({
        "is_train": True, "manual_seed": 0, "model_type": "StyleGAN2Model",
        "path": {"models": str(tmp_path / "m")}, "network_g": g_opt,
        "network_d": d_opt,
        "train": {"optim_g": {"type": "Adam", "lr": 2e-3},
                  "optim_d": {"type": "Adam", "lr": 2e-3},
                  "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                              "loss_weight": 1.0}}}, device=cuda_device)
    g = torch.Generator().manual_seed(4)
    codes = [torch.randn((2, 16), generator=g).to(cuda_device)
             for _ in range(2)]
    noise = [torch.randn(s, generator=g).to(cuda_device)
             for s in model.net_g.noise_shapes()]
    img_noise = torch.randn((2, 32, 32, 3), generator=g).to(cuda_device)

    def run():
        model.net_g.zero_grad()
        loss = model.path_loss(codes, 3, noise, img_noise)[0]
        loss.backward()
        return loss.item(), [torch.zeros_like(p) if p.grad is None
                             else p.grad.clone()
                             for p in model.net_g.parameters()]

    fused_act.fused_leaky_relu.launches = 0
    k = run()
    assert fused_act.fused_leaky_relu.launches == 2 * 2 + 7
    with mock.patch.object(fused_act, "fused_leaky_relu",
                           fused_act.fused_leaky_relu_plain):
        p = run()
    assert abs(k[0] - p[0]) <= 1e-5 * abs(p[0]), (k[0], p[0])
    scale = max(float(gb.abs().max()) for gb in p[1])
    for ga, gb in zip(k[1], p[1]):
        assert float((ga - gb).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_roi_align_on_card_matches_cpu(cuda_device, no_tf32):
    """`roi_align` (64² crops of ten boxes, some across the edge) and its
    gradient to the image on the card against the CPU (TF32 off)."""
    from image_restoration_tpu_torch.ops.roi_align import roi_align
    g = torch.Generator().manual_seed(5)
    img = torch.rand((2, 64, 256, 3), generator=g) * 2 - 1
    lo = torch.rand((2, 10, 2), generator=g) * torch.tensor([250.0, 60.0])
    boxes = torch.cat([lo - 4, lo + 20], -1)
    up = torch.randn((2, 10, 64, 64, 3), generator=g)
    outs = []
    for dev in ("cpu", cuda_device):
        x = img.to(dev).clone().requires_grad_(True)
        y = roi_align(x, boxes.to(dev), 64)
        (y * up.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), x.grad.cpu()))
    (y0, g0), (y1, g1) = outs
    assert float((y1 - y0).abs().max()) <= 1e-6
    assert float((g1 - g0).abs().max()) <= 1e-5 * float(g0.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_down", [False, True])
def test_char_ds_kernel_match_plain_and_cpu(cuda_device, no_tf32,
                                            monkeypatch, fuse_down):
    """The ten char Ds as one grouped FacialComponentDiscriminator on the
    card, K1 five launches a pass: against K1's plain version (bit-equal
    arithmetic, 1e-6 of max|y|) and against the CPU (1e-5 of max|y|), with
    and without FUSE_DOWN."""
    from unittest import mock
    from image_restoration_tpu_torch.archs import build_network
    from image_restoration_tpu_torch.ops import fused_act, fused_resample
    monkeypatch.setattr(fused_resample, "FUSE_DOWN", fuse_down)
    net = build_network(dict(type="FacialComponentDiscriminator",
                             groups=10))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    crops = torch.rand((10, 2, 64, 64, 3), generator=g) * 2 - 1
    with torch.no_grad():
        want = net.forward_stacked(crops, return_feats=True)
        card = net.to(cuda_device)
        fused_act.fused_leaky_relu.launches = 0
        got = card.forward_stacked(crops.to(cuda_device), return_feats=True)
        torch.cuda.synchronize()
        assert fused_act.fused_leaky_relu.launches == 5
        with mock.patch.object(fused_act, "fused_leaky_relu",
                               fused_act.fused_leaky_relu_plain):
            plain = card.forward_stacked(crops.to(cuda_device),
                                         return_feats=True)
    for a, p, c in zip([got[0]] + got[1], [plain[0]] + plain[1],
                       [want[0]] + want[1]):
        scale = float(c.abs().max())
        assert float((a - p).abs().max()) <= 1e-6 * scale
        assert float((a.cpu() - c).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_nearest_resize_exact_on_card(cuda_device):
    """`resize(..., "nearest")` on the card bit-equal to the CPU (a gather,
    whatever the card's matmul precision), down and up, at integer and
    other ratios; TF32 left at PyTorch's setting."""
    from image_restoration_tpu_torch.ops.resize import resize
    x = torch.rand((2, 30, 20, 3), generator=torch.Generator().manual_seed(
        7)) * 1000
    for out in ((7, 13), (2, 3), (60, 40), (64, 64)):
        got = resize(x.to(cuda_device), out, "nearest").cpu()
        assert torch.equal(got, resize(x, out, "nearest")), out


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["mobilenet0.25", "Resnet18"])
def test_train_mode_retinaface_on_card_matches_cpu(cuda_device, no_tf32,
                                                   backbone):
    """RetinaFace in train mode on the card against the CPU (TF32 off):
    outputs within 1e-4 of max(1, max|CPU|) and every updated running
    statistic within 1e-5 of max(1, max|CPU|)."""
    from image_restoration_tpu_torch.archs import build_network
    opt = dict(type="RetinaFace", backbone=backbone, phase="train",
               out_channel=64 if backbone == "mobilenet0.25" else 256)
    cpu = build_network(opt, torch.Generator().manual_seed(2)).train()
    card = build_network(opt).to(cuda_device).train()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(
        3)) * 255 - 120
    want = cpu(x)
    got = card(x.to(cuda_device))
    for w, g in zip(want, got):
        scale = max(1.0, float(w.detach().abs().max()))
        assert float((g.detach().cpu() - w.detach()).abs().max()) <= \
            1e-4 * scale
    for k, w in cpu.state_dict().items():
        if "running" in k:
            g = card.state_dict()[k].cpu()
            assert float((g - w).abs().max()) <= \
                1e-5 * max(1.0, float(w.abs().max())), k


@pytest.mark.cuda
def test_detector_step_on_card_matches_cpu(cuda_device, no_tf32):
    """One `DetectorTrainer` step (mobilenet0.25, 64², batch 2) on the
    card and the CPU from the same weights: losses within 1e-5 relative,
    the matched labels equal and the loc and landmark targets within 1e-6
    of max|CPU| (a log and divisions), the running statistics within 1e-5 of
    max(1, max|CPU|), the parameters within JAX's DP bound of 5e-3."""
    from image_restoration_tpu_torch.detect.multibox_loss import \
        match_targets
    from image_restoration_tpu_torch.detect.synth import make_batch
    from image_restoration_tpu_torch.detect.train import DetectorTrainer
    kw = dict(backbone="mobilenet0.25", image_size=64, lr=1e-2)
    cpu = DetectorTrainer(device="cpu", **kw)
    card = DetectorTrainer(device=cuda_device, **kw)
    card.net.load_state_dict(cpu.net.state_dict())
    imgs, targets = make_batch(torch.Generator().manual_seed(4), 2, 64)
    imgs = imgs - torch.tensor([104.0, 117.0, 123.0])
    want_t = match_targets(targets, cpu.priors)
    got_t = [t.cpu() for t in match_targets(targets.to(cuda_device),
                                            card.priors)]
    assert torch.equal(got_t[1], want_t[1])
    for g, w in zip(got_t, want_t):
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    want = cpu.train_step(imgs, targets)
    got = card.train_step(imgs, targets)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    for k, w in cpu.net.state_dict().items():
        g = card.net.state_dict()[k].cpu()
        bound = (1e-5 * max(1.0, float(w.abs().max())) if "running" in k
                 else 5e-3)
        assert float((g.float() - w.float()).abs().max()) <= bound, k


@pytest.mark.cuda
def test_hifacegan_step_on_card_matches_cpu(cuda_device, no_tf32, tmp_path):
    """One HiFaceGANModel G+D step (HiFaceGAN at num_feat 8, 64², lsgan,
    feature matching, SGD) on the card and the CPU from the same weights:
    losses within 1e-5 relative (D's mean logits 1e-5 absolute), G and D
    parameters within 1e-5 of max|p|."""
    from image_restoration_tpu_torch.models import build_model
    sgd = {"type": "SGD", "lr": 1e-3}
    opt = {"is_train": True, "manual_seed": 0, "model_type": "HiFaceGANModel",
           "scale": 1, "path": {"models": str(tmp_path)},
           "network_g": {"type": "HiFaceGAN", "num_feat": 8,
                         "is_train": False},
           "network_d": {"type": "HiFaceGANDiscriminator", "num_feat": 8},
           "train": {"optim_g": sgd, "optim_d": sgd,
                     "pixel_opt": {"type": "L1Loss"},
                     "gan_opt": {"type": "MultiScaleGANLoss",
                                 "gan_type": "lsgan"},
                     "feature_matching_opt": {"type": "GANFeatLoss",
                                              "loss_weight": 10.0}}}
    cpu = build_model(opt, device="cpu")
    card = build_model(opt, device=cuda_device)
    for name in ("net_g", "net_g_ema", "net_d"):
        getattr(card, name).load_state_dict(getattr(cpu, name).state_dict())
    g = torch.Generator().manual_seed(8)
    batch = {"lq": torch.rand((2, 64, 64, 3), generator=g),
             "gt": torch.rand((2, 64, 64, 3), generator=g)}
    want = cpu.optimize_parameters(1, batch)
    got = card.optimize_parameters(1, batch)
    for k, v in want.items():   # the mean logits near 0: absolute
        bound = 1e-5 * (1.0 if k.endswith("_score") else abs(float(v)))
        assert abs(float(got[k]) - float(v)) <= bound, k
    for name in ("net_g", "net_d"):
        want_sd = getattr(cpu, name).state_dict()
        got_sd = getattr(card, name).state_dict()
        scale = max(float(v.abs().max()) for v in want_sd.values())
        for k, v in want_sd.items():
            assert float((got_sd[k].cpu() - v).abs().max()) <= \
                1e-5 * scale, k
