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
