"""The port's `Restorer` over every single-image arch against the JAX
package's `Restorer` on the CPU.

Each arch at a narrow width serves the same weights on both sides, loaded
from one reference-layout `.pth` through each side's `ckpt_path`: the
port's net (drawn from a seed, every parameter perturbed so zero biases
count) is written out and JAX's `Restorer` imports it with
`import_network`. GFPGANv1, SPADEGenerator and HiFaceGAN, which JAX's
importer does not map, go the other way: JAX's `Restorer` draws them, the
flax tree is carried into the port's layout (`state_dict_from_jax`,
`hifacegan_state_dict_from_jax`), written as a `.pth` and served by the
port's `Restorer(ckpt_path=...)`. The SR archs take `SR_MEAN_STD` (RIDNet
its [0, 255] range). Tolerances: `restore_batch_u8` and
`restore_tiled_u8` ≤1 LSB; the float output ≤1e-5 of max|ref| (for
HiFaceGAN and SPADEGenerator tests/test_torch_hifacegan.py holds the float
forward, at 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

from image_restoration_tpu.infer import Restorer as JaxRestorer
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert.from_jax import (
    hifacegan_state_dict_from_jax, state_dict_from_jax)
from image_restoration_tpu_torch.infer import (IMAGE_ARCHS, SR_MEAN_STD,
                                               Restorer)

NARROW_GFPGAN = dict(input_width=32, input_height=32, num_style_feat=16,
                     channel_multiplier=0.25, num_mlp=2, input_is_latent=True,
                     different_w=True, narrow=0.5, sft_half=True)
RIDNET_RANGE = dict(mean=(0, 0, 0), std=(1 / 255,) * 3, out_min_max=(0, 255))
# (network options, normalization, the side that draws, tolerance, input)
CASES = {
    "GFPGANv1": (dict(type="GFPGANv1", **NARROW_GFPGAN), {}, "jax", 1e-5,
                 32),
    "MSRResNet": (dict(type="MSRResNet", num_feat=8, num_block=1, upscale=2),
                  SR_MEAN_STD, "port", 1e-5, 12),
    "EDSR": (dict(type="EDSR", num_feat=8, num_block=1, upscale=2,
                  res_scale=0.1), SR_MEAN_STD, "port", 1e-5, 12),
    "RCAN": (dict(type="RCAN", num_feat=16, num_group=1, num_block=1,
                  squeeze_factor=4, upscale=2), SR_MEAN_STD, "port", 1e-5,
             12),
    "RIDNet": (dict(type="RIDNet", mid_channels=16, num_block=1),
               RIDNET_RANGE, "port", 1e-5, 12),
    "SPADEGenerator": (dict(type="SPADEGenerator", num_feat=8), {}, "jax",
                       None, 64),
    "HiFaceGAN": (dict(type="HiFaceGAN", num_feat=8, is_train=False), {},
                  "jax", None, 64),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lsb(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _perturbed_port_net(opt, seed=0):
    net = build_network(opt, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            scale = 0.02 if p.dim() == 1 else 0.05 * float(p.std())
            p.add_(scale * torch.randn(p.shape, generator=g))
    return net


def _pair(name, tmp_path):
    """(JAX Restorer, port Restorer) serving the same weights."""
    opt, norm, side, _, _ = CASES[name]
    path = str(tmp_path / f"{name}.pth")
    if side == "port":
        sd = _perturbed_port_net(opt).state_dict()
        torch.save({"params_ema": sd}, path)
        jr = JaxRestorer(opt, ckpt_path=path, **norm)
    else:
        jr = JaxRestorer(opt, **norm)
        net = build_network(opt)
        conv = (hifacegan_state_dict_from_jax
                if name in ("SPADEGenerator", "HiFaceGAN")
                else state_dict_from_jax)
        torch.save({"params_ema": conv(net, jr.variables["params"])}, path)
    return jr, Restorer(opt, ckpt_path=path, device="cpu", **norm)


def _u8(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("name", list(CASES))
def test_restorer_arch_matches_jax(name, tmp_path):
    """restore_batch_u8 ≤1 LSB, the float forward within the tolerance,
    restore_tiled_u8 ≤1 LSB (the SR archs, tiled at their scale)."""
    jr, tr = _pair(name, tmp_path)
    opt, norm, _, tol, size = CASES[name]
    u8 = _u8((2, size, size, 3), 1)
    got = tr.restore_batch_u8(u8)
    assert _lsb(got, jr.restore_batch_u8(u8)) <= 1
    if tol is not None:
        x = ((u8 / 255.0 - tr.mean) / tr.std).astype(np.float32)
        want = np.asarray(jr._fwd(jr.variables["params"], x))
        with torch.no_grad():
            out = tr._fwd(torch.from_numpy(x)).numpy()
        assert np.abs(out - want).max() <= tol * np.abs(want).max()
    assert _lsb(tr.restore_batch(u8 / 255.0), got) <= 1
    if "upscale" in opt or name == "RIDNet":
        scale = opt.get("upscale", 1)
        img = _u8((20, 28, 3), 2)
        t = tr.restore_tiled_u8(img, tile=8, halo=4, scale=scale,
                                tile_batch=3)
        j = jr.restore_tiled_u8(img, tile=8, halo=4, scale=scale,
                                tile_batch=3)
        assert t.shape == (20 * scale, 28 * scale, 3)
        assert _lsb(t, np.asarray(j)) <= 1


@pytest.mark.parametrize("opt, why", [
    (dict(type="DFDNet"), "dictionary"),
    (dict(type="StyleGAN2Generator", out_size=32, num_style_feat=16),
     "style codes"),
    (dict(type="BasicVSR", num_feat=8, num_block=1), "clip"),
    (dict(type="StyleGAN2Discriminator", input_width=32, input_height=32),
     "not an image-to-image"),
], ids=["DFDNet", "StyleGAN2Generator", "BasicVSR", "D"])
def test_restorer_refuses_a_non_image_arch(opt, why):
    with pytest.raises(NotImplementedError, match=opt["type"]) as e:
        Restorer(opt, device="cpu")
    assert why in str(e.value)
    assert set(CASES) | {"GFPGANv1OCR", "SRVGGNetCompact",
                         "RRDBNet"} == set(IMAGE_ARCHS)
