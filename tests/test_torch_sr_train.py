"""The port's SR trainers (SRModel's L1 step, QAT, DistillModel), `ops/qat.py`
and the SR engine from a QAT checkpoint, against the JAX package.

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

from image_restoration_tpu.models import build_model as jax_build_model
from image_restoration_tpu.ops import qat as jqat
from image_restoration_tpu.ops import quantized_inference as jq
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import (qat_checkpoint_from_jax,
                                                 state_dict_from_jax)
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.ops import qat as tqat
from image_restoration_tpu_torch.ops import quantized_inference as tq
from image_restoration_tpu_torch.serve.sr_engine import build_graph
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
    from image_restoration_tpu.archs import build_network as jax_build
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
