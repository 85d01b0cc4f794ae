"""The port's SR trainers (SRModel's L1 step, QAT, DistillModel, SRGANModel,
ESRGANModel and their discriminators), `ops/qat.py`, `test.py` and the SR
engine from a QAT checkpoint, against the JAX package.

Tiny sizes: SRVGG num_feat 8 with 2 convs, an RRDBNet teacher of 1 block
and 8 features, batch 2. The same numpy-seeded batch and weights (flax
params, perturbed so zero biases count, carried by `convert/from_jax.py`)
go to both sides. Tolerances: forwards ≤1e-5 absolute; STE gradients
≤1e-5 of max|g|; losses ≤1e-5 relative; parameters after Adam steps
≤1e-5 of max|p| (at most 1 element in 10³ within 2·lr a step: Adam's ε
regime, see `_check_params`); `update_qscale`, the int8 export and the
int8 engine exact.
"""

import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.models import build_model as jax_build_model
from image_restoration_tpu.ops import qat as jqat
from image_restoration_tpu.ops import quantized_inference as jq
from image_restoration_tpu.test import test_pipeline as jax_test_pipeline
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import (
    discriminator_state_dict_from_jax, qat_checkpoint_from_jax,
    state_dict_from_jax, vgg_state_dict_from_jax)
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.ops import qat as tqat
from image_restoration_tpu_torch.ops import quantized_inference as tq
from image_restoration_tpu_torch.serve.sr_engine import build_graph
from image_restoration_tpu_torch.test import \
    test_pipeline as port_test_pipeline
from image_restoration_tpu_torch.train import train_pipeline

SRVGG = {"type": "SRVGGNetCompact", "num_feat": 8, "num_conv": 2,
         "upscale": 2}
RRDB_T = {"type": "RRDBNet", "num_feat": 8, "num_block": 1,
          "num_grow_ch": 4, "scale": 2}
ATOL = 1e-5
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its ops are small, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), params)


def _srvgg_pair(seed=0):
    """(flax params, port net) of one tiny SRVGG."""
    jnet = jax_build(SRVGG)
    params = jnet.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 8, 8, 3)))["params"]
    params = _perturb(params, seed + 1)
    net = build_network(SRVGG)
    net.load_state_dict(state_dict_from_jax(net, params), strict=True)
    return params, net


def _batch(seed=2):
    rng = np.random.default_rng(seed)
    return {"lq": rng.random((2, 8, 8, 3)).astype(np.float32),
            "gt": rng.random((2, 16, 16, 3)).astype(np.float32)}


# ------------------------------------------------------------ ops/qat.py


@pytest.mark.parametrize("observed", [False, True])
def test_qat_forward_matches_jax(observed):
    """The fake-quant forward and its batch maxima; with the scales at 0
    (the dynamic fallback) and at observed values."""
    params, net = _srvgg_pair()
    x = np.random.default_rng(3).random((2, 10, 12, 3)).astype(np.float32)
    qs = np.zeros(5, np.float32)
    if observed:
        qs = np.asarray(jq.calibrate_srvgg_act_scales(
            params, jnp.asarray(x), 2)) * np.float32(0.8)
    want, wmax = jqat.qat_srvgg_forward(params, jnp.asarray(x),
                                        jnp.asarray(qs), 2, 2)
    got, gmax = tqat.qat_srvgg_forward(net, _t(x), _t(qs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(gmax.numpy(), np.asarray(wmax), rtol=1e-6)


@pytest.mark.parametrize("qmax", [127, 7])
def test_qat_ste_gradients_match_jax(qmax):
    """The parameters' gradients through the straight-through estimators
    (weights at 8 and 4 bits, activations clipped at scales below the
    batch's max, so the pass band gates some), ≤1e-5 of max|g|."""
    params, net = _srvgg_pair(4)
    x = np.random.default_rng(5).random((2, 8, 8, 3)).astype(np.float32)
    qs = np.asarray(jq.calibrate_srvgg_act_scales(
        params, jnp.asarray(x), 2)) * np.float32(0.7)

    def loss(p):
        out, _ = jqat.qat_srvgg_forward(p, jnp.asarray(x), jnp.asarray(qs),
                                        2, 2, weight_qmax=qmax)
        return jnp.mean(out ** 2)

    jgrads = jax.grad(loss)(params)
    out, _ = tqat.qat_srvgg_forward(net, _t(x), _t(qs), weight_qmax=qmax)
    torch.mean(out ** 2).backward()
    want = state_dict_from_jax(net, jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    scale = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        d = float((p.grad - want[name]).abs().max())
        assert d <= 1e-5 * scale, (name, d, scale)


def test_fake_quant_act_gradient_gated_to_pass_band():
    """tests/test_qat.py:85 on the port: an element clipped to ±127·s gets
    no gradient; with the scale at 0 nothing is clipped."""
    x = torch.tensor([-2.0, -0.5, 0.0, 0.9, 3.0], requires_grad=True)
    y = tqat.fake_quant_act(x, torch.tensor(1.0))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])
    np.testing.assert_allclose(y.detach().numpy()[[0, 4]], [-1.0, 1.0])
    x.grad = None
    tqat.fake_quant_act(x, torch.tensor(0.0)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(5))


@pytest.mark.parametrize("qmax", [127, 7])
def test_fake_quant_weight_matches_jax(qmax):
    """Per output channel: the port's OIHW against JAX's HWIO."""
    w = np.random.default_rng(6).standard_normal((3, 3, 5, 4)).astype(
        np.float32)
    want = np.asarray(jqat.fake_quant_weight(jnp.asarray(w), qmax))
    got = tqat.fake_quant_weight(_t(w.transpose(3, 2, 0, 1)), qmax)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


def test_update_qscale_matches_jax_exactly():
    rng = np.random.default_rng(7)
    qs = rng.random(7).astype(np.float32)
    qs[[1, 4]] = 0.0  # not observed yet: adopt the batch max
    bm = rng.random(7).astype(np.float32) * 3
    want = np.asarray(jqat.update_qscale(jnp.asarray(qs), jnp.asarray(bm),
                                         0.9))
    got = tqat.update_qscale(_t(qs), _t(bm), 0.9).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == bm[1] and got[4] == bm[4]


def test_export_int8_bit_equal_to_jax_and_refuses_untrained():
    """Key by key against JAX's serving pytree (the port's int8 weights
    are (Cout, 3, 3, Cin), JAX's HWIO); all-zero scales refuse, as
    tests/test_qat.py:110."""
    params, net = _srvgg_pair(8)
    x = np.random.default_rng(9).random((2, 12, 12, 3)).astype(np.float32)
    qs = np.asarray(jq.calibrate_srvgg_act_scales(params, jnp.asarray(x),
                                                  2))
    want = jqat.export_int8(params, qs, 2, pack=2)
    got = tqat.export_int8(net, _t(qs), pack=2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].float().numpy() if got[k].dtype != torch.int8 else \
            got[k].numpy().transpose(1, 2, 3, 0)
        np.testing.assert_array_equal(g, v.astype(g.dtype), err_msg=k)
    with pytest.raises(ValueError, match="untrained"):
        tqat.export_int8(net, torch.zeros(5))


# ------------------------------------------------------------ the steps


def _opt(tmp, model_type="SRModel", **train):
    t = {"optim_g": {"type": "Adam", "lr": 1e-3},
         "scheduler": {"type": "MultiStepLR", "milestones": [1000],
                       "gamma": 0.5},
         "total_iter": 1000, "ema_decay": 0.9,
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}}
    t.update(train)
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "scale": 2, "gt_size": 16, "model_type": model_type,
            "path": {"models": str(tmp / "models"),
                     "visualization": str(tmp / "vis"),
                     "pretrain_network_g": None},
            "logger": {"print_freq": 1}, "network_g": dict(SRVGG),
            "train": {k: v for k, v in t.items() if v is not None}}


def _check_losses(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= REL * abs(w), (k, g, w)


def _check_params(net, flax_params, lr=1e-3, steps=2,
                  convert=state_dict_from_jax):
    """Parameters (and buffers) within 1e-5 of max|p|, except that at most
    1 element in 10³ may be off by up to 2·lr per step: a gradient that
    cancels to within float32 rounding of 0 (|g| ~ 1e-10) puts Adam in its
    ε regime, where g/(|g| + 1e-8) is any value in (−1, 1) on either
    side (lr=0: an optimizer without that regime, every element within
    1e-5)."""
    want = convert(net, jax.tree_util.tree_map(np.asarray, flax_params))
    scale = max(float(v.abs().max()) for v in want.values())
    got = net.state_dict()
    over, total = 0, 0
    for k in want:
        d = (got[k] - want[k]).abs()
        assert float(d.max()) <= max(2 * lr * steps, 1e-5 * scale), \
            (k, float(d.max()))
        over += int((d > 1e-5 * scale).sum())
        total += d.numel()
    assert over <= total * 1e-3, (over, total)


def _pair(tmp, opt, carry=("net_g",)):
    """The JAX model and the port's, with the JAX G's perturbed weights in
    both (and the port's EMA copy)."""
    jm = jax_build_model(copy.deepcopy(opt))
    params = _perturb(jm.state["params_g"], 11)
    jm.state = dict(jm.state, params_g=params, ema_g=params)
    port = build_model(opt, device="cpu")
    sd = state_dict_from_jax(port.net_g, params)
    port.net_g.load_state_dict(sd)
    port.net_g_ema.load_state_dict(sd)
    return jm, port


@pytest.mark.parametrize("quant", [False, True])
def test_sr_step_matches_jax(tmp_path, quant):
    """Two SRModel steps (L1, Adam, EMA; under quant_opt the fake-quant
    forward and the scales' EMA): losses, G and EMA params and qscale."""
    opt = _opt(tmp_path, quant_opt={"ema_decay": 0.9} if quant else None)
    jm, port = _pair(tmp_path, opt)
    batch = _batch()
    key = jax.random.PRNGKey(0)
    for it in (1, 2):
        want = jm.optimize_parameters(it, dict(batch), key)
        got = port.optimize_parameters(it, dict(batch))
        _check_losses(got, want)
    _check_params(port.net_g, jm.state["params_g"])
    _check_params(port.net_g_ema, jm.state["ema_g"])
    assert port.iter == int(jm.state["iter"]) == 2
    if quant:
        np.testing.assert_allclose(port.qscale.numpy(),
                                   np.asarray(jm.state["qscale"]), rtol=1e-6)
        assert (port.qscale > 0).all()


def test_sr_step_grad_clip_and_grad_mask(tmp_path):
    """grad_clip runs inside the step (against optax's chain); a False leaf
    of the static grad mask gets a zero gradient that Adam still steps."""
    opt = _opt(tmp_path, optim_g={"type": "Adam", "lr": 1e-3,
                                  "grad_clip": 1e-3})
    jm, port = _pair(tmp_path, opt)
    jm._grad_mask_tree = jax.tree_util.tree_map(
        lambda _: True, jm.state["params_g"])
    jm._grad_mask_tree["body_0"]["kernel"] = False
    port.grad_mask = {"body.0.weight": False}
    batch = _batch(12)
    for it in (1, 2):
        want = jm.optimize_parameters(it, dict(batch), jax.random.PRNGKey(0))
        got = port.optimize_parameters(it, dict(batch))
        _check_losses(got, want)
    _check_params(port.net_g, jm.state["params_g"])


def _distill_opt(tmp, **train):
    opt = _opt(tmp, "DistillModel",
               distill_opt={"type": "L1Loss", "loss_weight": 1.0},
               pixel_opt={"type": "L1Loss", "loss_weight": 0.5}, **train)
    opt["network_t"] = dict(RRDB_T)
    return opt


@pytest.mark.parametrize("quant", [False, True])
def test_distill_step_matches_jax(tmp_path, quant):
    """Two DistillModel steps at the same student and teacher (float32):
    losses and params; the teacher bit-frozen; quant_opt composes."""
    opt = _distill_opt(tmp_path, allow_random_teacher=True,
                       quant_opt={"ema_decay": 0.9} if quant else None)
    jm, port = _pair(tmp_path, opt)
    pt = _perturb(jm.state["params_t"], 13)
    jm.set_teacher_params(pt)
    port.net_t.load_state_dict(state_dict_from_jax(port.net_t, pt))
    t0 = copy.deepcopy(port.net_t.state_dict())
    batch = _batch(14)
    for it in (1, 2):
        want = jm.optimize_parameters(it, dict(batch), jax.random.PRNGKey(0))
        got = port.optimize_parameters(it, dict(batch))
        _check_losses(got, want)
    _check_params(port.net_g, jm.state["params_g"])
    _check_params(port.net_g_ema, jm.state["ema_g"])
    for k, v in port.net_t.state_dict().items():
        assert torch.equal(v, t0[k]), k
    assert all(p.grad is None for p in port.net_t.parameters())
    trained = {id(p) for p in port.optimizer_g.params}
    assert not any(id(p) in trained for p in port.net_t.parameters())


def test_distill_refuses_random_teacher_and_checkpoint_excludes_it(tmp_path):
    """tests/test_distill.py:48 and :68 on the port: no teacher, no step
    (set_teacher_params unblocks it); the checkpoint holds no teacher, and
    a resume restores the rest and keeps the live teacher."""
    opt = _distill_opt(tmp_path)
    model = build_model(opt, device="cpu")
    batch = _batch(15)
    with pytest.raises(ValueError, match="random-init teacher"):
        model.optimize_parameters(1, dict(batch))
    model.set_teacher_params(model.net_t.state_dict())
    assert torch.isfinite(model.optimize_parameters(1, dict(batch))
                          ["l_distill"])
    path = model.save(1)
    state = torch.load(path, weights_only=True)
    assert not any("net_t" in k or k == "params_t" for k in state)
    assert "params_g" in state and "qscale" not in state
    again = build_model(dict(opt, train=dict(opt["train"],
                                             allow_random_teacher=True)),
                        device="cpu")
    t_live = copy.deepcopy(again.net_t.state_dict())
    again.resume(path)
    assert again.iter == 1
    for k, v in again.net_t.state_dict().items():
        assert torch.equal(v, t_live[k]), k
    for k, v in again.net_g.state_dict().items():
        assert torch.equal(v, model.net_g.state_dict()[k]), k
    with pytest.raises(ValueError, match="distill_opt"):
        build_model(dict(opt, train={k: v for k, v in opt["train"].items()
                                     if k != "distill_opt"}), device="cpu")


def test_qat_refusals(tmp_path):
    """tests/test_qat.py:221 on the port: quant_opt on an arch that is not
    SRVGG with PReLU, and on a trainer with its own step."""
    base = _opt(tmp_path, quant_opt={})
    with pytest.raises(ValueError, match="SRVGGNetCompact"):
        build_model(dict(base, network_g=dict(RRDB_T)), device="cpu")
    with pytest.raises(ValueError, match="SRVGGNetCompact"):
        build_model(dict(base, network_g=dict(SRVGG, act_type="relu")),
                    device="cpu")
    srgan = dict(base, model_type="SRGANModel",
                 network_d={"type": "VGGStyleDiscriminator128",
                            "num_in_ch": 3, "num_feat": 4})
    srgan["train"] = dict(base["train"], optim_d={"type": "Adam",
                                                  "lr": 1e-3},
                          gan_opt={"type": "GANLoss", "gan_type": "vanilla",
                                   "loss_weight": 0.1})
    with pytest.raises(ValueError, match="not supported"):
        build_model(srgan, device="cpu")
    with pytest.raises(RuntimeError, match="quant_opt"):
        build_model(_opt(tmp_path), device="cpu").export_quantized()


# --------------------------------------------- QAT checkpoint → engine


def _span_psnr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    span = max(a.max() - a.min(), 1e-9)
    return 10 * np.log10(span ** 2 / max(np.mean((a - b) ** 2), 1e-20))


def test_qat_checkpoint_engine_matches_jax(tmp_path):
    """A JAX QAT run's state (2 steps), carried into the port's checkpoint
    layout by `qat_checkpoint_from_jax`, builds the int8 engine: equal
    bit for bit to JAX's engine from the same state, and ≥35 dB against
    the fake-quant twin at the exported scales (tests/test_qat.py:30-52)."""
    opt = _opt(tmp_path, quant_opt={"ema_decay": 0.9})
    jm = jax_build_model(copy.deepcopy(opt))
    for it in (1, 2):
        jm.optimize_parameters(it, _batch(16), jax.random.PRNGKey(it))
    net = build_network(SRVGG)
    ckpt = tmp_path / "ckpt_2.pth"
    torch.save(qat_checkpoint_from_jax(net, jax.tree_util.tree_map(
        np.asarray, dict(jm.state))), ckpt)
    graph, meta = build_graph(num_feat=8, num_conv=2, upscale=2, tile=8,
                              halo=2, batch=2, io="bf16",
                              qat_ckpt=str(ckpt), device="cpu")
    assert meta["qat"] and meta["mode"] == "int8"
    x = np.random.default_rng(17).random((2, 12, 12, 3)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    q = jqat.export_int8(jm.state["ema_g"], jm.state["qscale"], 2, pack=2)
    want = np.asarray(jq.quantized_srvgg_forward(q, xb, 2, 2, pack=2)
                      .astype(jnp.float32))
    with torch.inference_mode():
        got = graph(torch.from_numpy(np.asarray(xb, np.float32))
                    .bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)
    fake, _ = jqat.qat_srvgg_forward(jm.state["ema_g"], xb.astype(
        jnp.float32), jm.state["qscale"], 2, 2)
    assert _span_psnr(fake, got) >= 35


def test_qat_engine_checks(tmp_path):
    """export_restorer's checks (scripts/export_restorer.py:53-80): --pth
    and --qat-ckpt exclusive, --bf16 refused, num_conv from the scales,
    scales > 0, num_feat and upscale from the checkpoint's shapes."""
    model = build_model(_opt(tmp_path, quant_opt={}), device="cpu")
    path = str(tmp_path / "ckpt_0.pth")
    torch.save(model.training_state(), path)
    kw = dict(num_feat=8, num_conv=2, upscale=2, tile=8, halo=2, batch=2,
              io="bf16", qat_ckpt=path, device="cpu")
    with pytest.raises(ValueError, match="untrained"):
        build_graph(**kw)
    model.optimize_parameters(1, _batch(18))
    model.save(1)
    path = str(tmp_path / "models" / "ckpt_1.pth")
    kw["qat_ckpt"] = path
    for bad, match in [(dict(pth="x.pth"), "mutually exclusive"),
                       (dict(int8=False), "bf16"),
                       (dict(num_conv=3), "num_conv"),
                       (dict(num_feat=16), "num_feat"),
                       (dict(upscale=4), "upscale")]:
        with pytest.raises(ValueError, match=match):
            build_graph(**dict(kw, **bad))
    graph, meta = build_graph(**kw)
    x = torch.rand((2, 12, 12, 3), generator=torch.Generator().manual_seed(
        0)).bfloat16()
    q = model.export_quantized(pack=2)
    with torch.inference_mode():
        np.testing.assert_array_equal(
            graph(x).float().numpy(),
            tq.quantized_srvgg_forward(q, x, 2, 2, pack=2).float().numpy())


# --------------------------------------------------- the configs end to end


def _write_images(folder, n, hw, seed):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(folder, f"img_{i}.png"),
                    (rng.random(hw + (3,)) * 255).astype(np.uint8))


def _tiny_argv(tmp, config, *extra):
    """`train_pipeline`'s argv for `config` at the tiny widths: 2 steps of
    batch 2 at gt 48, validation and a checkpoint at 2, on the images under
    `tmp`."""
    return ["-opt", config, "--force_yml",
            f"datasets:train:dataroot_gt={tmp}/gt",
            f"datasets:val:dataroot_gt={tmp}/val",
            "network_g:num_feat=8", "network_g:num_conv=2",
            "path:pretrain_network_g=~", "train:total_iter=2",
            "datasets:train:gt_size=48", "datasets:val:gt_size=48",
            "datasets:train:batch_size_per_gpu=2", "val:val_freq=2",
            "logger:save_checkpoint_freq=2", "logger:use_tb_logger=false",
            *extra]


def test_qat_config_trains_and_serves(tmp_path):
    """configs/train_qat_srvgg_x4.yml at the tiny widths through
    `train_pipeline` (the Real-ESRGAN chain inside the step, validation,
    a checkpoint), its `ckpt_2.pth` built into the int8 engine through
    the exporter's `build_engine`, and the engine against
    `quantized_srvgg_forward` of the trained model (bit-equal) and the
    fake-quant twin (≥35 dB)."""
    from image_restoration_tpu_torch.scripts.export_restorer import \
        build_engine
    _write_images(tmp_path / "gt", 4, (56, 60), 19)
    _write_images(tmp_path / "val", 2, (48, 48), 20)
    model = train_pipeline(str(tmp_path), argv=_tiny_argv(
        tmp_path, "configs/train_qat_srvgg_x4.yml"), device="cpu")
    assert model.iter == 2 and set(model.log_dict) == {"l_pix"}
    assert (model.qscale > 0).all()
    ckpt = tmp_path / "experiments" / "train_qat_srvgg_x4" / "models" / \
        "ckpt_2.pth"
    _, meta, graph = build_engine(num_feat=8, num_conv=2, upscale=4, tile=8,
                                  halo=2, batch=2, qat_ckpt=str(ckpt),
                                  device="cpu")
    x = torch.rand((2, 12, 12, 3), generator=torch.Generator().manual_seed(
        1)).bfloat16()
    with torch.inference_mode():
        got = graph(x).float()
        want = tq.quantized_srvgg_forward(model.export_quantized(), x, 2, 4)
        fake, _ = tqat.qat_srvgg_forward(model.net_g_ema, x.float(),
                                         model.qscale)
    np.testing.assert_array_equal(got.numpy(), want.float().numpy())
    assert _span_psnr(fake.numpy(), got.numpy()) >= 35


def test_distill_config_trains(tmp_path):
    """configs/train_distill_rrdb_to_srvgg.yml at the tiny widths, its
    `dtype: bf16` teacher from a `.pth`, through `train_pipeline`: the
    teacher bit-unchanged, both loss terms finite."""
    _write_images(tmp_path / "gt", 4, (48, 48), 21)
    _write_images(tmp_path / "val", 1, (48, 48), 22)
    teacher = build_network(dict(RRDB_T, scale=4),
                            torch.Generator().manual_seed(3))
    torch.save({"params_ema": teacher.state_dict()}, tmp_path / "t.pth")
    with open("configs/train_distill_rrdb_to_srvgg.yml") as f:
        assert yaml.safe_load(f)["network_t"]["dtype"] == "bf16"
    model = train_pipeline(str(tmp_path), argv=_tiny_argv(
        tmp_path, "configs/train_distill_rrdb_to_srvgg.yml",
        f"path:pretrain_network_t={tmp_path}/t.pth",
        "network_t:num_feat=8", "network_t:num_block=1",
        "network_t:num_grow_ch=4"), device="cpu")
    assert model.net_t.dtype == torch.bfloat16
    assert set(model.log_dict) == {"l_distill", "l_pix"}
    assert all(np.isfinite(v) for v in model.log_dict.values())
    for k, v in model.net_t.state_dict().items():
        assert torch.equal(v, teacher.state_dict()[k]), k


def test_sr_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Unset, the device is cuda: without a GPU the SR trainers, the test
    pipeline and the engine from a QAT checkpoint raise rather than run on
    the CPU."""
    from image_restoration_tpu_torch.test import \
        test_pipeline as port_test_pipeline
    model = build_model(_opt(tmp_path, quant_opt={}), device="cpu")
    model.optimize_parameters(1, _batch(23))
    ckpt = model.save(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model_type in ("SRModel", "DistillModel"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(_distill_opt(tmp_path, allow_random_teacher=True)
                        if model_type == "DistillModel" else _opt(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_graph(num_feat=8, num_conv=2, upscale=2, qat_ckpt=ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_test_pipeline(str(tmp_path), argv=[
            "-opt", "configs/test_esrgan_x4.yml", "--force_yml",
            "path:pretrain_network_g=~"])


def test_port_registry_names_are_jax_names():
    """Every arch, model and dataset the port registers carries the JAX
    package's `type:` name, and every JAX dataset type is registered in the
    port. Every registering module of both packages is imported first, so
    the result does not depend on what ran before in the worker."""
    import importlib
    import pkgutil
    from image_restoration_tpu.models import register_all_models
    from image_restoration_tpu.utils import registry as jreg
    from image_restoration_tpu_torch.utils import registry as treg
    register_all_models()
    for pkg in ("image_restoration_tpu", "image_restoration_tpu_torch"):
        models = importlib.import_module(f"{pkg}.models")
        mods = ["archs", "data.datasets", "data.video_datasets"] + [
            f"models.{m.name}" for m in pkgutil.iter_modules(models.__path__)]
        for mod in mods:
            importlib.import_module(f"{pkg}.{mod}")  # registration
    for name in ("ARCH_REGISTRY", "MODEL_REGISTRY", "DATASET_REGISTRY"):
        port, ref = getattr(treg, name), getattr(jreg, name)
        missing = [k for k in port.keys() if k not in ref]
        assert not missing, (name, missing)
    unported = [k for k in jreg.DATASET_REGISTRY.keys()
                if k not in treg.DATASET_REGISTRY]
    assert not unported, unported
    for k in ("SRGANModel", "ESRGANModel", "DistillModel", "SRModel"):
        assert k in treg.MODEL_REGISTRY
    for k in ("VGGStyleDiscriminator128", "VGGStyleDiscriminator256",
              "UNetDiscriminatorSN"):
        assert k in treg.ARCH_REGISTRY

# ------------------------------------------------------------------------
# SRGANModel, ESRGANModel, their discriminators and `test.py`.
#
# Tiny sizes: an RRDBNet G of 1 block and 8 features (×4, 32² → 128²), the
# VGG-style D at num_feat 4, batch 2, the perceptual loss at conv1_2. The
# same numpy-seeded batch and weights (flax params and BatchNorm statistics,
# perturbed, carried by `convert/from_jax.py`) go to both sides.
# Tolerances: D forwards ≤1e-5 absolute, and so the mean logits
# (`real_score`, `fake_score`); the refreshed running statistics ≤1e-6
# (≤1e-4 after a whole step, see `test_gan_steps_match_jax`); losses ≤1e-5
# relative; parameters after Adam steps as `_check_params` states; PSNR
# within 1e-3 dB.


RRDB_G = {"type": "RRDBNet", "num_feat": 8, "num_block": 1,
          "num_grow_ch": 4, "scale": 4}


def _jax_d(typ, size, seed=0, **kw):
    """(flax net, variables with perturbed params and positive running
    variances, port net holding the same)."""
    jnet = jax_build(dict(type=typ, num_in_ch=3, num_feat=4, **kw))
    v = dict(jax.jit(jnet.init)(jax.random.PRNGKey(seed),
                                jnp.zeros((1, size, size, 3))))
    v = {"params": _perturb(v["params"], seed + 1),
         **({"batch_stats": jax.tree_util.tree_map(
             lambda a: np.abs(a) + 0.5, _perturb(v["batch_stats"], seed + 2))}
            if "batch_stats" in v else {})}
    net = build_network(dict(type=typ, num_in_ch=3, num_feat=4, **kw))
    net.load_state_dict(discriminator_state_dict_from_jax(net, v),
                        strict=True)
    return jnet, v, net


def _x(n, size, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("typ,size", [("VGGStyleDiscriminator128", 128),
                                      ("VGGStyleDiscriminator256", 256),
                                      ("UNetDiscriminatorSN", 32)])
def test_discriminator_forward_matches_jax(typ, size):
    """Train mode (batch statistics) and, for the BatchNorm Ds, eval mode
    (running statistics)."""
    jnet, v, net = _jax_d(typ, size)
    x = _x(2, size, 3)
    has_stats = "batch_stats" in v
    # jitted: an eager flax forward compiles each op on its own
    want = jax.jit(lambda v, x: jnet.apply(v, x, **(
        dict(train=True, mutable=["batch_stats"]) if has_stats else {})))(
            v, jnp.asarray(x))
    want = want[0] if has_stats else want
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    if has_stats:
        net.eval()
        with torch.no_grad():
            got = net(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(
            jnet.apply)(v, jnp.asarray(x))), rtol=0, atol=1e-5)


def test_spectral_conv_loads_reference_keys():
    """A reference checkpoint (torch's spectral_norm: weight_orig,
    weight_u, weight_v) loads strictly; σ is the fixed-start estimate."""
    _, _, net = _jax_d("UNetDiscriminatorSN", 32)
    sd = dict(net.state_dict())
    sd["conv1.weight_u"] = torch.zeros(8)
    sd["conv1.weight_v"] = torch.zeros(4 * 16)
    net.load_state_dict(sd, strict=True)
    w = net.conv1.weight_orig.detach().permute(2, 3, 1, 0).reshape(-1, 8)
    sigma = float(torch.linalg.matrix_norm(w, ord=2))
    assert abs(float(net.conv1.sigma()) - sigma) <= 0.05 * sigma


# --------------------------------------------------- SRGAN / ESRGAN steps


def _gan_opt(tmp, model_type, **train):
    t = {"optim_g": {"type": "Adam", "lr": 1e-3},
         "optim_d": {"type": "Adam", "lr": 1e-3},
         "scheduler": {"type": "MultiStepLR", "milestones": [1000],
                       "gamma": 0.5},
         "total_iter": 1000, "ema_decay": 0.9,
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2},
         "perceptual_opt": {"type": "PerceptualLoss",
                            "layer_weights": {"conv1_2": 1},
                            "vgg_type": "vgg19", "use_input_norm": True,
                            "range_norm": False, "perceptual_weight": 1.0,
                            "style_weight": 0, "criterion": "l1"},
         "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                     "loss_weight": 5e-3},
         "net_d_iters": 1, "net_d_init_iters": 1}
    t.update(train)
    return {"is_train": True, "manual_seed": 0, "num_devices": 1,
            "scale": 4, "gt_size": 128, "model_type": model_type,
            "path": {"models": str(tmp / "models"),
                     "visualization": str(tmp / "vis"),
                     "pretrain_network_g": None},
            "logger": {"print_freq": 1}, "network_g": dict(RRDB_G),
            "network_d": {"type": "VGGStyleDiscriminator128",
                          "num_in_ch": 3, "num_feat": 4},
            "train": t}


SGD = {"type": "SGD", "lr": 1e-3}


@pytest.fixture(scope="module")
def jax_gan_models(tmp_path_factory):
    """One JAX model of each type (building one takes ~10 s), with SGD
    (see `test_gan_steps_match_jax`) and perturbed weights; tests restore
    its first state."""
    tmp = tmp_path_factory.mktemp("gan")
    models = {}
    for model_type in ("SRGANModel", "ESRGANModel"):
        opt = _gan_opt(tmp, model_type, optim_g=SGD, optim_d=SGD)
        jm = jax_build_model(copy.deepcopy(opt))
        pg = _perturb(jm.state["params_g"], 21)
        stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5,
                                       _perturb(jm.state["stats_d"], 23))
        jm.state = dict(jm.state, params_g=pg, ema_g=pg,
                        params_d=_perturb(jm.state["params_d"], 22),
                        stats_d=stats)
        models[model_type] = (jm, dict(jm.state), opt)
    return models


def _gan_pair(jax_gan_models, model_type):
    """The cached JAX model at its first state, and a port model holding
    the same G, D (with statistics) and VGG weights."""
    jm, state, opt = jax_gan_models[model_type]
    jm.state = dict(state)
    port = build_model(opt, device="cpu")
    g = state_dict_from_jax(port.net_g, state["params_g"])
    port.net_g.load_state_dict(g)
    port.net_g_ema.load_state_dict(g)
    port.net_d.load_state_dict(discriminator_state_dict_from_jax(
        port.net_d, {"params": state["params_d"],
                     "batch_stats": state["stats_d"]}))
    port.cri_perceptual.vgg.load_state_dict(vgg_state_dict_from_jax(
        port.cri_perceptual.vgg, jm.cri_perceptual.vgg_variables["params"]))
    return jm, port


def _gan_batch(seed=24):
    rng = np.random.default_rng(seed)
    gt = rng.random((2, 128, 128, 3)).astype(np.float32)
    lq = cv2.resize(gt.transpose(1, 2, 0, 3).reshape(128, 128, 6), (32, 32),
                    interpolation=cv2.INTER_AREA)
    return {"lq": lq.reshape(32, 32, 2, 3).transpose(2, 0, 1, 3).copy(),
            "gt": gt}


def _check_gan_losses(got, want):
    """Losses ≤1e-5 relative; the mean logits are D forwards, ≤1e-5
    absolute (BatchNorm at batch 2 normalizes by E[x²] − E[x]², which
    amplifies float32 rounding into their last digits)."""
    scores = ("real_score", "fake_score")
    _check_losses({k: v for k, v in got.items() if k not in scores},
                  {k: v for k, v in want.items() if k not in scores})
    for k in scores:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k


def _d_params_from_jax(net, variables):
    """D's parameters only (its statistics are `_check_d_stats`')."""
    return {k: v for k, v in discriminator_state_dict_from_jax(
        net, variables).items() if "running" not in k}


def _check_d_stats(net_d, stats, atol=1e-6, rtol=0.0):
    for name, m in net_d.named_modules():
        if name.startswith("bn"):
            np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(
                stats[name]["mean"]), rtol=rtol, atol=atol, err_msg=name)
            np.testing.assert_allclose(m.running_var.numpy(), np.asarray(
                stats[name]["var"]), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("model_type", ["SRGANModel", "ESRGANModel"])
def test_gan_steps_match_jax(jax_gan_models, model_type):
    """Iteration 1 is a skipped G iteration (net_d_init_iters 1: no G
    update, its optimizer untouched, EMA and D step all the same);
    iteration 2 a full one. Losses, G, EMA and D params, and D's running
    statistics after both; against JAX's step run eagerly. D with
    BatchNorm at batch 2 is sensitive: its first layers' gradients move
    ~1e-5 relative per 1e-7 of change in its input, and JAX's jitted G
    output is ~4e-6 from its eager one (which the port's equals here).
    For the same reason SGD with momentum (optax's `sgd` against torch's;
    Adam against optax is held in tests/test_torch_train_losses.py):
    Adam's first steps turn a gradient that cancels to float32 rounding of
    0 into a step of up to lr. D's statistics, refreshed by the updated D
    (its deepest BatchNorm sees 32 values a channel), are held at 1e-4;
    `_refresh_d_stats` alone is held at 1e-6 below."""
    jm, port = _gan_pair(jax_gan_models, model_type)
    batch = _gan_batch()
    g0 = copy.deepcopy(port.net_g.state_dict())
    with jax.disable_jit():
        want = jm.optimize_parameters(1, dict(batch), jax.random.PRNGKey(0))
    got = port.optimize_parameters(1, dict(batch))
    _check_gan_losses(got, want)
    assert not any(k.startswith("l_g") for k in got)
    assert port.optimizer_g.count == 0 and not port.optimizer_g.opt.state \
        and port.optimizer_d.count == 1
    for k, v in port.net_g.state_dict().items():
        assert torch.equal(v, g0[k]), k
    _check_d_stats(port.net_d, jm.state["stats_d"], atol=1e-4)
    with jax.disable_jit():
        want = jm.optimize_parameters(2, dict(batch), jax.random.PRNGKey(0))
    got = port.optimize_parameters(2, dict(batch))
    _check_gan_losses(got, want)
    assert {"l_g_pix", "l_g_percep", "l_g_gan", "l_d"} <= set(got)
    _check_params(port.net_g, jm.state["params_g"], lr=0)
    _check_params(port.net_g_ema, jm.state["ema_g"], lr=0)
    _check_params(port.net_d, {"params": jm.state["params_d"],
                               "batch_stats": jm.state["stats_d"]},
                  lr=0, convert=_d_params_from_jax)
    _check_d_stats(port.net_d, jm.state["stats_d"], atol=1e-4)
    assert port.optimizer_g.count == 1 and port.optimizer_d.count == 2


@pytest.mark.parametrize("model_type", ["SRGANModel", "ESRGANModel"])
def test_gan_losses_and_grads_match_jax(jax_gan_models, model_type):
    """At one output image: the GAN part of G's loss (relativistic for
    ESRGAN, every stop-gradient where JAX puts it) and its gradient with
    respect to the output, leaving no gradient on D; and the D losses and
    D's gradients; against `jax.value_and_grad` of JAX's own terms."""
    jm, port = _gan_pair(jax_gan_models, model_type)
    gt, out = _x(2, 128, 25) * 0.5 + 0.5, _x(2, 128, 26) * 0.5 + 0.5
    st = jm.state["stats_d"]
    jl, jg = jax.jit(jax.value_and_grad(lambda o: jm._gan_g_loss(
        jm.state["params_d"], o, jnp.asarray(gt), stats=st)))(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    port.net_d.requires_grad_(False)
    lg = port._gan_g_loss(o, torch.from_numpy(gt))
    lg.backward()
    port.net_d.requires_grad_(True)
    assert all(p.grad is None for p in port.net_d.parameters())
    _check_losses({"g": lg}, {"g": jl})
    scale = float(np.abs(np.asarray(jg)).max())
    assert float((o.grad - _t(jg)).abs().max()) <= 1e-5 * scale

    def d_loss(pd):
        return jm._gan_d_losses(pd, jnp.asarray(out), jnp.asarray(gt),
                                stats=st)

    (jl, jparts), jgrads = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(
        jm.state["params_d"])
    l_d, parts = port._gan_d_losses(o.detach(), torch.from_numpy(gt))
    l_d.backward()
    _check_gan_losses(dict(parts, l_d=l_d), dict(jparts, l_d=jl))
    _check_grads(port.net_d, discriminator_state_dict_from_jax(
        port.net_d, {"params": jax.tree_util.tree_map(np.asarray, jgrads),
                     "batch_stats": st}))


def _check_grads(net, want, tol=1e-5):
    scale = max(float(want[n].abs().max()) for n, _ in
                net.named_parameters())
    for name, p in net.named_parameters():
        d = float((p.grad - want[name]).abs().max())
        assert d <= tol * scale, (name, d, scale)


def test_refresh_d_stats_matches_jax(jax_gan_models):
    """`_refresh_d_stats` (from the GT, then the output) ≤1e-6."""
    jm, port = _gan_pair(jax_gan_models, "SRGANModel")
    gt, out = _x(2, 128, 26), _x(2, 128, 27)
    want = jm._refresh_d_stats(jm.state["params_d"], jm.state["stats_d"],
                               jnp.asarray(out), jnp.asarray(gt))
    port._refresh_d_stats(torch.from_numpy(out), torch.from_numpy(gt))
    _check_d_stats(port.net_d, want)


# ------------------------------------------------------ test.py and CLIs


def _pairs(root, n, seed, scale=4, hw=32):
    os.makedirs(root / "gt", exist_ok=True)
    os.makedirs(root / "lq", exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        gt = (rng.random((hw, hw, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"img_{i}.png"), gt)
        cv2.imwrite(str(root / "lq" / f"img_{i}.png"), cv2.resize(
            gt, (hw // scale, hw // scale), interpolation=cv2.INTER_AREA))


def test_test_pipeline_matches_jax(tmp_path):
    """configs/test_esrgan_x4.yml's shape at a tiny RRDBNet from one `.pth`
    on a synthetic paired folder: PSNR and SSIM within 1e-3 dB (and 1e-5)
    of JAX's test pipeline, and the restored images written."""
    _pairs(tmp_path, 3, 28)
    net = build_network(RRDB_G, torch.Generator().manual_seed(1))
    torch.save({"params_ema": net.state_dict()}, tmp_path / "g.pth")
    argv = ["-opt", "configs/test_esrgan_x4.yml", "--force_yml",
            f"datasets:test_1:dataroot_gt={tmp_path}/gt",
            f"datasets:test_1:dataroot_lq={tmp_path}/lq",
            f"path:pretrain_network_g={tmp_path}/g.pth",
            "network_g:num_feat=8", "network_g:num_block=1",
            "network_g:num_grow_ch=4"]
    got = port_test_pipeline(str(tmp_path / "port"), argv=argv, device="cpu")
    want = jax_test_pipeline(str(tmp_path / "jax"), argv=argv)
    assert set(got) == set(want) == {"Set14"}
    assert abs(got["Set14"]["psnr"] - want["Set14"]["psnr"]) <= 1e-3
    assert abs(got["Set14"]["ssim"] - want["Set14"]["ssim"]) <= 1e-5
    vis = tmp_path / "port" / "results" / "test_ESRGAN_x4" / "visualization"
    assert len(list(vis.iterdir())) == 3


def test_esrgan_config_trains_then_tests(tmp_path):
    """configs/train_esrgan_x4.yml at the tiny widths through
    `train_pipeline` (paired 128² crops, VGG-style D, 2 iterations,
    validation and a checkpoint), then `test.py` with
    configs/test_esrgan_x4.yml on the run's `net_g_2.pth`."""
    _pairs(tmp_path / "train", 2, 29, hw=136)
    _pairs(tmp_path / "val", 1, 30)
    model = train_pipeline(str(tmp_path), argv=[
        "-opt", "configs/train_esrgan_x4.yml", "--force_yml",
        f"datasets:train:dataroot_gt={tmp_path}/train/gt",
        f"datasets:train:dataroot_lq={tmp_path}/train/lq",
        f"datasets:val:dataroot_gt={tmp_path}/val/gt",
        f"datasets:val:dataroot_lq={tmp_path}/val/lq",
        "datasets:train:batch_size_per_gpu=2", "network_g:num_feat=8",
        "network_g:num_block=1", "network_g:num_grow_ch=4",
        "network_d:num_feat=4", "train:total_iter=2",
        "train:perceptual_opt:layer_weights={conv1_2: 1}",
        "val:val_freq=2", "logger:save_checkpoint_freq=2",
        "logger:use_tb_logger=false"], device="cpu")
    assert model.iter == 2 and model.optimizer_d.count == 2
    assert {"l_g_pix", "l_g_percep", "l_g_gan", "l_d"} <= \
        set(model.log_dict)
    assert all(np.isfinite(v) for v in model.log_dict.values())
    ckpt = tmp_path / "experiments" / "train_ESRGAN_x4" / "models" / \
        "net_g_2.pth"
    res = port_test_pipeline(str(tmp_path), argv=[
        "-opt", "configs/test_esrgan_x4.yml", "--force_yml",
        f"datasets:test_1:dataroot_gt={tmp_path}/val/gt",
        f"datasets:test_1:dataroot_lq={tmp_path}/val/lq",
        f"path:pretrain_network_g={ckpt}", "network_g:num_feat=8",
        "network_g:num_block=1", "network_g:num_grow_ch=4"], device="cpu")
    assert np.isfinite(res["Set14"]["psnr"]) and \
        -1 <= res["Set14"]["ssim"] <= 1
