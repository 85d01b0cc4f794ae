"""The port's identity loss and its ArcFace IResNet against the JAX package.

IResNet18 at flax's random init, its FoldedBN scale/shift perturbed so the
BatchNorm mapping counts, carried by `iresnet_state_dict_from_jax`, against
flax (≤1e-4 of max|emb|); a synthetic insightface `state_dict` (random
parameters and running statistics, as tests/test_iresnet.py builds one)
through the port's `import_iresnet` (as a dict and as a `.pth` with DDP's
"module." prefix) and JAX's `import_iresnet`, which agree (≤1e-4 of
max|emb|); the identity loss — bilinear to 112², clamped, L1 of the
embeddings with the GT's taken without gradient, or the mean |Δ| without
`L1_opt` — and its gradient to the G output against `jax.value_and_grad`
of JAX's (`models/gfpgan_model.py:226-230`, `:274-283`; loss ≤1e-5
relative, gradient ≤1e-4 of max|grad|); the frozen net in the trainer;
and `debug_nans: true`, which turns autograd's anomaly mode on.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build_network
from image_restoration_tpu.convert.iresnet_import import \
    import_iresnet as jax_import_iresnet
from image_restoration_tpu.losses import build_loss as jax_build_loss
from image_restoration_tpu.ops.resize import resize as jax_resize
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import (import_iresnet,
                                                 iresnet_state_dict_from_jax)
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.models.gfpgan_model import GFPGANModel
from image_restoration_tpu_torch.train import train_pipeline
from image_restoration_tpu_torch.utils.debug import (enable_nan_checks,
                                                     nan_checks)

EMB_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ID_WEIGHT = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_iresnet():
    """JAX's IResNet18 (512 features) at its random init, every FoldedBN's
    scale and shift perturbed."""
    net = jax_build_network(dict(type="IResNet18"))
    params = jax.device_get(jax.jit(net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3)))["params"])
    rng = np.random.default_rng(1)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key == "scale":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1].key in ("shift", "bias"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return net, jax.tree_util.tree_map_with_path(perturb, params)


def _port_from(flax_net_params):
    _, params = flax_net_params
    net = build_network(dict(type="IResNet18"))
    net.load_state_dict(iresnet_state_dict_from_jax(net, params))
    return net


def _emb_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=EMB_TOL * np.abs(want).max())


def test_iresnet18_matches_flax(flax_iresnet):
    jnet, params = flax_iresnet
    x = np.random.default_rng(2).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, t: jnet.apply({"params": p}, t))(
        params, jnp.asarray(x))
    net = _port_from(flax_iresnet).train()   # BatchNorms stay frozen
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 512)
    _emb_close(got, want)


def _insightface_state_dict(seed):
    """insightface iresnet18's keys and shapes (the port's own), random
    parameters and running statistics."""
    net = build_network(dict(type="IResNet18"))
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    return sd


@pytest.mark.parametrize("form", ["state_dict", "pth"])
def test_import_iresnet_agrees_with_jax(tmp_path, form):
    sd = _insightface_state_dict(3)
    net = build_network(dict(type="IResNet18"))
    if form == "pth":
        path = tmp_path / "arcface.pth"
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   path)
        import_iresnet(str(path), net)
    else:
        import_iresnet({k: v.numpy() for k, v in sd.items()}, net)
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v), k
    x = np.random.default_rng(4).uniform(-1, 1, (2, 112, 112, 3)).astype(
        np.float32)
    jnet = jax_build_network(dict(type="IResNet18"))
    jparams = jax_import_iresnet({k: v.numpy() for k, v in sd.items()})
    want = jax.jit(lambda p, t: jnet.apply({"params": p}, t))(
        jparams, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _emb_close(got, want)


# --------------------------------------------------------- identity loss

def _model_opt(tmp, l1=True, **extra):
    t = {"optim_g": {"type": "Adam", "lr": 2e-3},
         "optim_d": {"type": "Adam", "lr": 2e-3},
         "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                     "loss_weight": 0.1},
         "identity_weight": ID_WEIGHT, "net_d_reg_every": 2}
    if l1:
        t["L1_opt"] = {"type": "L1Loss", "loss_weight": 1.0}
    opt = {"is_train": True, "manual_seed": 0, "num_devices": 1,
           "model_type": "GFPGANModel",
           "path": {"models": str(tmp / "models"),
                    "visualization": str(tmp / "vis")},
           "network_g": dict(type="GFPGANv1OCR", input_width=32,
                             input_height=32, num_style_feat=16,
                             channel_multiplier=0.25, num_mlp=2,
                             input_is_latent=True, different_w=True,
                             narrow=0.5, sft_half=True),
           "network_d": dict(type="StyleGAN2Discriminator", input_width=32,
                             input_height=32, channel_multiplier=0.25,
                             narrow=0.25),
           "network_identity": {"type": "IResNet18"}, "train": t}
    opt.update(extra)
    return opt


@pytest.mark.parametrize("l1", [True, False])
def test_identity_loss_and_grad_match_jax(tmp_path, flax_iresnet, l1):
    """L1_opt's loss of the two embeddings (or the mean |Δ| without it),
    times identity_weight, at a 32×64 output stretched to 112²."""
    jnet, params = flax_iresnet
    cri_l1 = jax_build_loss({"type": "L1Loss", "loss_weight": 1.0})
    rng = np.random.default_rng(5)
    gt = rng.uniform(-1.2, 1.2, (2, 32, 64, 3)).astype(np.float32)
    out = (gt + rng.normal(0, 0.3, gt.shape)).astype(np.float32)

    def embed(img):         # JAX gfpgan_model.py:226-230
        r = jnp.clip(jax_resize(img, (112, 112), "bilinear"), -1.0, 1.0)
        return jnet.apply({"params": params}, r)

    def loss(output):       # JAX gfpgan_model.py:274-283
        e_out = embed(output)
        e_gt = jax.lax.stop_gradient(embed(jnp.asarray(gt)))
        if l1:
            return cri_l1(e_out, e_gt) * ID_WEIGHT
        return jnp.mean(jnp.abs(e_out - e_gt)) * ID_WEIGHT

    jl, jgrad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(out))
    model = build_model(_model_opt(tmp_path, l1=l1), device="cpu")
    model.net_identity.load_state_dict(
        iresnet_state_dict_from_jax(model.net_identity, params))
    x = torch.from_numpy(out).requires_grad_(True)
    got = model.identity_loss(x, torch.from_numpy(gt))
    got.backward()
    assert abs(float(got) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=0,
                               atol=GRAD_TOL * np.abs(jgrad).max())
    assert all(p.grad is None for p in model.net_identity.parameters())


def test_identity_net_is_frozen_in_the_step(tmp_path):
    """One step with the identity loss: l_identity logged, the IResNet's
    tensors bit-unchanged, out of every optimizer and of the training
    state; a `pretrain_network_identity` .pth loads through the
    importer."""
    sd = _insightface_state_dict(6)
    pth = tmp_path / "arcface.pth"
    torch.save(sd, pth)
    opt = _model_opt(tmp_path)
    opt["path"]["pretrain_network_identity"] = str(pth)
    model = build_model(opt, device="cpu")
    before = {k: v.clone() for k, v in model.net_identity.state_dict().items()}
    for k, v in sd.items():
        assert torch.equal(before[k], v), k
    gt = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    logs = model.optimize_parameters(1, {"gt": gt, "lq": gt * 0.5})
    assert "l_identity" in logs and torch.isfinite(logs["l_identity"])
    for k, v in model.net_identity.state_dict().items():
        assert torch.equal(v, before[k]), k
    ids = {id(p) for p in model.net_identity.parameters()}
    assert not any(id(p) in ids for tx in model.optimizers
                   for p in tx.params)
    state = model.training_state()
    assert not any("identity" in k for k in state)
    assert not any("layer4.1.bn3.running_var" in v for v in state.values()
                   if isinstance(v, dict))


# ------------------------------------------------------------ debug_nans

def test_nan_checks_switches_anomaly_mode():
    assert not torch.is_anomaly_enabled()
    with nan_checks():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    assert not torch.is_anomaly_enabled()
    enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


IDENTITY_CONFIG = "configs/train_gfpgan_plate_256_identity.yml"


@pytest.mark.parametrize("debug_nans", [True, False])
def test_train_pipeline_honours_debug_nans(tmp_path, monkeypatch,
                                           debug_nans):
    """`debug_nans: true` in the options turns anomaly mode on for the
    run (JAX's train.py:71-73 turns on jax_debug_nans); unset, it stays
    off. The identity config at tiny overrides, one iteration."""
    os.makedirs(tmp_path / "gt")
    rng = np.random.default_rng(8)
    for i in range(2):
        cv2.imwrite(str(tmp_path / "gt" / f"img_{i}.png"),
                    (rng.random((40, 40, 3)) * 255).astype(np.uint8))
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    argv = ["-opt", os.path.join(root, IDENTITY_CONFIG), "--force_yml",
            "train:total_iter=1", "logger:use_tb_logger=false",
            "datasets:train:batch_size_per_gpu=1",
            f"datasets:train:dataroot_gt={tmp_path}/gt",
            f"datasets:val:dataroot_gt={tmp_path}/gt",
            "datasets:train:input_width=32", "datasets:train:input_height=32",
            "datasets:val:input_width=32", "datasets:val:input_height=32",
            "network_g:input_width=32", "network_g:input_height=32",
            "network_g:num_style_feat=16", "network_g:num_mlp=2",
            "network_g:channel_multiplier=0.25", "network_g:narrow=0.5",
            "network_d:input_width=32", "network_d:input_height=32",
            "network_d:channel_multiplier=0.25", "network_d:narrow=0.25",
            f"debug_nans={str(debug_nans).lower()}"]
    seen = []
    step = GFPGANModel.optimize_parameters

    def spy(self, *a, **k):
        seen.append(torch.is_anomaly_enabled())
        return step(self, *a, **k)

    monkeypatch.setattr(GFPGANModel, "optimize_parameters", spy)
    try:
        model = train_pipeline(str(tmp_path), argv=argv, device="cpu")
    finally:
        enable_nan_checks(False)
    assert seen == [debug_nans]
    assert np.isfinite(model.log_dict["l_identity"])
