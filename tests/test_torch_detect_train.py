"""The port's detector trainer against the JAX package on the CPU: matching
and the encoders, the MultiBox loss and its gradient, RetinaFace in train
mode with its BatchNorm statistics, the torchvision trunk import, one
`DetectorTrainer` step, the LR schedule, `preproc` under a shared
`random.seed`, and the synthetic scenes; then the CLI, `eval_detector` and
`detector_convergence --tiny`, which have no JAX counterpart to compare.

mobilenet0.25 at 64² unless stated (one Resnet18 case for its BatchNorm
structure). Tolerances: matched labels exact (loc and landmark targets
≤1e-6 relative), losses ≤1e-5 relative, gradients ≤1e-5 (loss) or ≤1e-4
(a whole step) of max|grad|, BatchNorm statistics ≤1e-5 of max(1,
max|ref|), the train-mode forward within the JAX golden's 2e-4 of
max|ref|.
"""

import copy
import os
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.detect import box_utils as jbu
from image_restoration_tpu.detect import dataset as jds
from image_restoration_tpu.detect import synth as jsynth
from image_restoration_tpu.detect.multibox_loss import \
    multibox_loss as jax_multibox_loss
from image_restoration_tpu.detect.priors import prior_box as jax_prior_box
from image_restoration_tpu.detect.config import get_cfg
from image_restoration_tpu.detect.train import \
    DetectorTrainer as JaxDetectorTrainer
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import retinaface_state_dict_from_jax
from image_restoration_tpu_torch.detect import box_utils as tbu
from image_restoration_tpu_torch.detect import dataset as tds
from image_restoration_tpu_torch.detect import synth as tsynth
from image_restoration_tpu_torch.detect.engine import PlateDetector
from image_restoration_tpu_torch.detect.multibox_loss import (
    match_targets, multibox_loss)
from image_restoration_tpu_torch.detect.train import DetectorTrainer, main
from test_torch_detect import port_and_jax

VAR = (0.1, 0.2)
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


def _priors(size=64, backbone="mobilenet0.25"):
    return jax_prior_box(get_cfg(backbone), (size, size))


def _targets(rng, b, m=6):
    """(b, m, 15) targets: plates with landmarks (1), without (−1), a
    plate too small for any prior to reach 0.2, padding rows (0), and in
    image 0 two plates that share their best prior."""
    t = np.zeros((b, m, 15), np.float32)
    for i in range(b):
        for j, label in enumerate((1.0, -1.0, 1.0)):
            c = rng.uniform(0.25, 0.75, 2)
            wh = rng.uniform(0.15, 0.45, 2) * [1.0, 0.4]
            t[i, j, :4] = np.concatenate([c - wh / 2, c + wh / 2])
            t[i, j, 4:14] = np.tile(c, 5) + rng.normal(0, 0.05, 10)
            t[i, j, 14] = label
        t[i, 3, :4] = [0.50, 0.50, 0.505, 0.503]   # a speck: best IoU < 0.2
        t[i, 3, 4:14] = 0.5
        t[i, 3, 14] = 1.0
    t[0, 4] = t[0, 0]                            # the same plate twice,
    t[0, 4, :4] += [0.001, 0.0, 0.001, 0.0]      # nudged: one best prior
    t[0, 4, 14] = -1.0
    return t


def test_point_form_and_encoders_match_jax():
    rng = np.random.default_rng(0)
    priors = _priors()
    boxes = np.sort(rng.random((priors.shape[0], 4)).astype(np.float32), 1)
    landm = rng.random((priors.shape[0], 10)).astype(np.float32)
    for got, want in (
            (tbu.point_form(_t(priors)), jbu.point_form(priors)),
            (tbu.encode(_t(boxes), _t(priors), VAR),
             jbu.encode(boxes, priors, jnp.asarray(VAR))),
            (tbu.encode_landm(_t(landm), _t(priors), VAR),
             jbu.encode_landm(landm, priors, jnp.asarray(VAR)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("threshold", [0.35, 0.5])
def test_match_matches_jax(threshold):
    """`match` batched over 3 images against JAX's per image: conf equal,
    loc and landmark targets ≤1e-6. In image 0 rows 0 and 4 share their
    best prior (the later, row 4, claims it, in JAX's scatter as here),
    and the speck in row 3, whose best overlap is under 0.2, shares its
    best prior with row 1 and so undoes row 1's claim, as JAX's scatter
    writes the prior's old values back; padding rows in every image."""
    rng = np.random.default_rng(1)
    priors = _priors()
    t = _targets(rng, 3)
    labels = np.abs(np.sign(t[..., 14]))
    pf = jbu.point_form(priors)
    ov = np.asarray(jbu.jaccard(t[0, :, :4], pf))
    best = ov.argmax(1)
    assert best[0] == best[4] and ov[0].max() >= 0.2   # the duplicate case
    assert best[1] == best[3] and ov[3].max() < 0.2    # the speck's undo
    got = tbu.match(_t(t[..., :4]), _t(labels), _t(t[..., 4:14]),
                    _t(priors), VAR, threshold)
    for i in range(3):
        want = jbu.match(t[i, :, :4], labels[i], t[i, :, 4:14], priors,
                         jnp.asarray(VAR), threshold)
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        for g, w in ((got[0][i], want[0]), (got[2][i], want[2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    # the later duplicate (row 4) owns the shared prior
    assert int(got[1][0, best[0]]) == 1
    forced = tbu.encode(_t(t[0, 4:5, :4]).expand(priors.shape[0], 4),
                        _t(priors), VAR)[best[0]]
    np.testing.assert_allclose(got[0][0, best[0]].numpy(), forced.numpy(),
                               rtol=1e-6)
    # row 1's best prior is left to its own overlaps (below threshold)
    assert ov[:, best[1]].max() < threshold and int(got[1][0, best[1]]) == 0


def _preds(rng, b, p):
    return (rng.normal(0, 1, (b, p, 4)).astype(np.float32),
            rng.normal(0, 2, (b, p, 2)).astype(np.float32),
            rng.normal(0, 1, (b, p, 10)).astype(np.float32))


def test_multibox_loss_and_gradient_match_jax():
    """The three losses ≤1e-5 relative and their gradient with respect to
    loc, conf and landm ≤1e-5 of max|grad|, on targets with signed
    labels, a speck and padding; the matched targets' signs as JAX's."""
    rng = np.random.default_rng(2)
    priors = _priors()
    t = _targets(rng, 2)
    preds = _preds(rng, 2, priors.shape[0])

    def jloss(pr):
        l_loc, l_conf, l_landm = jax_multibox_loss(pr, priors, t, VAR)
        return 2.0 * l_loc + l_conf + l_landm, (l_loc, l_conf, l_landm)

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        tuple(jnp.asarray(p) for p in preds))
    tp = tuple(_t(p).requires_grad_(True) for p in preds)
    got = multibox_loss(tp, _t(priors), _t(t), VAR)
    (2.0 * got[0] + got[1] + got[2]).backward()
    for g, w in zip(got, want):
        assert abs(float(g.detach()) - float(w)) <= REL * abs(float(w))
    for g, w in zip(tp, jgrads):
        w = np.asarray(w)
        assert np.abs(g.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    _, conf_t, _ = match_targets(_t(t), _t(priors), VAR)
    assert set(np.unique(conf_t.numpy())) == {-1.0, 0.0, 1.0}


def test_multibox_mining_ties_keep_prior_order():
    """Equal mining scores rank in prior order (a stable sort, as
    `jnp.argsort`): with every conf logit equal, the negatives taken are
    the first 7·n_pos non-positive priors, as in JAX."""
    rng = np.random.default_rng(3)
    priors = _priors()
    t = _targets(rng, 1)
    p = priors.shape[0]
    loc, _, landm = _preds(rng, 1, p)
    conf = np.zeros((1, p, 2), np.float32)
    want = jax.jit(lambda pr: jax_multibox_loss(pr, priors, t, VAR))(
        (loc, conf, landm))
    got = multibox_loss((_t(loc), _t(conf), _t(landm)), _t(priors), _t(t),
                        VAR)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= REL * abs(float(w))


def _pair_nets(backbone, size, seed=0):
    """(port net in train mode, flax net, flax variables) with the same
    perturbed weights and statistics."""
    tnet, jnet, variables, _ = port_and_jax(backbone, size, seed)
    return tnet.train(), jnet, variables


@pytest.mark.parametrize("backbone", ["mobilenet0.25", "Resnet18"])
def test_train_mode_forward_and_batch_stats_match_jax(backbone):
    """RetinaFace(phase="train") in train mode against flax's
    `apply(train=True, mutable=["batch_stats"])`: every updated running
    mean and variance ≤1e-5 of max(1, max|ref|) (biased variance, momentum
    0.9), and loc, conf and landm within the JAX golden's 2e-4 of max|ref|
    (batch statistics at batch 2 amplify rounding: both sides lie 1-6e-5
    from a float64 forward); back in eval mode the forward reads the new
    statistics, as flax's eval does."""
    tnet, _, variables = _pair_nets(backbone, 64)
    opt = dict(type="RetinaFace", backbone=backbone,
               out_channel=64 if backbone == "mobilenet0.25" else 256,
               phase="train")
    jnet = jax_build(opt)
    tnet.phase = "train"
    x = np.random.default_rng(4).random((2, 64, 64, 3)).astype(
        np.float32) * 255 - 120
    want, mutated = jax.jit(lambda v, x: jnet.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = tnet(_t(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= \
            2e-4 * np.abs(w).max()
    new = retinaface_state_dict_from_jax(
        tnet, {"params": variables["params"], **mutated})
    sd = tnet.state_dict()
    stats = [k for k in new if "running" in k]
    assert stats
    for k in stats:
        w = new[k].numpy()
        assert np.abs(sd[k].numpy() - w).max() <= \
            1e-5 * max(1.0, np.abs(w).max()), k
    tnet.eval()
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {"params": variables["params"], **mutated}, x)
    with torch.no_grad():
        got = tnet(_t(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-4 * np.abs(w).max()


def test_torchvision_resnet_import_matches_jax(tmp_path):
    """A torchvision resnet18 `.pth` (with `fc.*` and
    `num_batches_tracked`) into the trunk: the same tensors as JAX's
    `load_torchvision_resnet` puts into flax; the rest of the net
    untouched; a resnet50 key raises."""
    from image_restoration_tpu.convert.resnet_import import \
        load_torchvision_resnet as jax_load
    from image_restoration_tpu_torch.convert.resnet_import import \
        load_torchvision_resnet
    net = build_network(dict(type="RetinaFace", backbone="Resnet18",
                             out_channel=256, phase="train"))
    rng = np.random.default_rng(5)
    sd = {}
    for k, v in net.state_dict().items():
        if k.startswith("body."):
            a = rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32)
            sd[k[len("body."):]] = torch.from_numpy(
                np.abs(a) + 0.5 if "running_var" in k else a)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "resnet18.pth")
    before = copy.deepcopy(net.state_dict())
    load_torchvision_resnet(str(tmp_path / "resnet18.pth"), net)
    jnet = jax_build(dict(type="RetinaFace", backbone="Resnet18",
                          out_channel=256, phase="train"))
    shapes = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x),
                            jnp.zeros((1, 64, 64, 3)))
    variables = jax_load(str(tmp_path / "resnet18.pth"),
                         jax.tree_util.tree_map(
                             lambda a: np.zeros(a.shape, a.dtype), shapes))
    want = retinaface_state_dict_from_jax(net, variables)
    got = net.state_dict()
    for k, w in want.items():
        if k.startswith("body."):
            np.testing.assert_array_equal(got[k].numpy(), w.numpy(), k)
        else:
            assert torch.equal(got[k], before[k]), k
    bad = {"layer3.5.conv3.weight": torch.zeros(1024, 256, 1, 1)}
    with pytest.raises(KeyError, match="layer3.5.conv3"):
        load_torchvision_resnet(bad, net)


# ------------------------------------------------------------ the trainer


@pytest.fixture(scope="module")
def jax_trainer():
    """JAX's trainer at mobilenet0.25, 64² (its jitted step compiles
    once); tests restore its first state."""
    jt = JaxDetectorTrainer(backbone="mobilenet0.25", image_size=64,
                            lr=1e-2, decay_steps=[100])
    rng = np.random.default_rng(6)
    # perturbed statistics and BN affine, so normalization is exercised
    state = jax.device_get(jt.state)
    state["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(0, 0.2, a.shape)) + 0.5).astype(
            np.float32), state["batch_stats"])
    jt.state = state
    return jt, copy.deepcopy(state)


def _batch(seed=7, b=2):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 64, 64, 3)).astype(np.float32) * 40
    return images, _targets(rng, b)


def _port_from(jt, **kw):
    tr = DetectorTrainer(backbone="mobilenet0.25", image_size=64, lr=1e-2,
                         decay_steps=[100], device="cpu", **kw)
    tr.net.load_state_dict(retinaface_state_dict_from_jax(
        tr.net, {"params": jt.state["params"],
                 "batch_stats": jt.state["batch_stats"]}))
    return tr


def test_detector_step_matches_jax(jax_trainer):
    """One step: losses ≤1e-5 relative; the gradient (every parameter)
    ≤1e-4 of max|grad| against `jax.grad` of JAX's step loss; after the
    SGD step parameters ≤5e-3 (JAX's own DP bound: a mining tie may move
    O(1) gradient between anchors) and the running statistics ≤1e-5 of
    max(1, max|ref|). One step: at lr 1e-2 the step moves the first convs
    by O(1), so a second step amplifies float32 rounding past any fixed
    bound (the momentum trace is held in `test_sgd_matches_optax_chain`)."""
    jt, state0 = jax_trainer
    jt.state = copy.deepcopy(state0)
    port = _port_from(jt)
    images, targets = _batch()

    def jloss(params):
        preds, _ = jt.net.apply({"params": params,
                                 "batch_stats": state0["batch_stats"]},
                                images, train=True, mutable=["batch_stats"])
        l_loc, l_conf, l_landm = jax_multibox_loss(preds, jt.priors, targets,
                                                   VAR)
        return 2.0 * l_loc + l_conf + l_landm

    jgrads = jax.jit(jax.grad(jloss))(state0["params"])
    total, _ = port.losses(_t(images), _t(targets))
    total.backward()
    want = retinaface_state_dict_from_jax(port.net, {
        "params": jax.tree_util.tree_map(np.asarray, jgrads),
        "batch_stats": state0["batch_stats"]})
    scale = max(float(want[n].abs().max())
                for n, _ in port.net.named_parameters())
    for n, p in port.net.named_parameters():
        assert float((p.grad - want[n]).abs().max()) <= 1e-4 * scale, n
    port = _port_from(jt)
    want = jt.train_step(images, targets)
    got = port.train_step(images, targets)
    assert set(got) == set(want) == {"loss", "l_loc", "l_conf", "l_landm"}
    for k in want:
        assert abs(float(got[k]) - want[k]) <= REL * abs(want[k]), k
    ref = retinaface_state_dict_from_jax(port.net, jax.device_get(
        {"params": jt.state["params"],
         "batch_stats": jt.state["batch_stats"]}))
    sd = port.net.state_dict()
    for k, w in ref.items():
        bound = (1e-5 * max(1.0, float(w.abs().max()))
                 if "running" in k else 5e-3)
        assert float((sd[k] - w).abs().max()) <= bound, k
    assert port.step == int(jt.state["step"]) == 1


def test_sgd_matches_optax_chain():
    """The trainer's optimizer against JAX's `add_decayed_weights` →
    `sgd(momentum)` scaled by the schedule, over 4 steps that cross a
    decay boundary: parameters ≤1e-6 of max|p| (the momentum trace and
    the weight decay added before it)."""
    import optax
    rng = np.random.default_rng(11)
    p0 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    grads = [rng.normal(0, 1, (5, 7)).astype(np.float32) for _ in range(4)]
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(learning_rate=1.0, momentum=0.9))
    sched = optax.piecewise_constant_schedule(0.1, {2: 0.1})
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for i, g in enumerate(grads):
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(
            lambda a: a * sched(i), u))
    tr = DetectorTrainer(backbone="mobilenet0.25", image_size=64, lr=0.1,
                         decay_steps=[2], device="cpu")
    w = torch.nn.Parameter(_t(p0))
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9, weight_decay=5e-4)
    for i, g in enumerate(grads):
        opt.param_groups[0]["lr"] = tr.lr_at(i)
        w.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                               atol=1e-6 * np.abs(p0).max())
    assert type(tr.optimizer) is torch.optim.SGD
    assert tr.optimizer.defaults["momentum"] == 0.9 and \
        tr.optimizer.defaults["weight_decay"] == 5e-4


def test_lr_schedule_follows_step(jax_trainer):
    """The decay reads the trainer's `step`: the first update from step 10
    (past the boundary at 3, momentum empty, no weight decay) is 0.1× the
    one from step 0, as tests/test_detect.py holds for JAX; `lr_at`
    equals optax's piecewise-constant schedule (float32) at every count."""
    import optax
    jt, _ = jax_trainer
    fresh = DetectorTrainer(backbone="mobilenet0.25", image_size=64, lr=1e-2,
                            weight_decay=0.0, decay_steps=[3], device="cpu")
    sd0 = copy.deepcopy(fresh.net.state_dict())
    images, targets = _batch(8, 1)

    def first_update_norm(start):
        tr = DetectorTrainer(backbone="mobilenet0.25", image_size=64,
                             lr=1e-2, weight_decay=0.0, decay_steps=[3],
                             device="cpu")
        tr.net.load_state_dict(sd0)
        tr.step = start
        before = {n: p.detach().clone() for n, p in tr.net.named_parameters()}
        tr.train_step(images, targets)
        return sum(float((p.detach() - before[n]).abs().sum())
                   for n, p in tr.net.named_parameters())

    np.testing.assert_allclose(first_update_norm(10) / first_update_norm(0),
                               0.1, rtol=1e-3)
    sched = optax.piecewise_constant_schedule(1e-3, {70: 0.1, 90: 0.1})
    tr = DetectorTrainer(backbone="mobilenet0.25", image_size=64, lr=1e-3,
                         decay_steps=[70, 90], device="cpu")
    for s in (0, 69, 70, 71, 89, 90, 500):
        assert abs(tr.lr_at(s) - float(sched(s))) <= 1e-6 * tr.lr_at(s), s


def test_data_parallel_raises_and_device_defaults_to_cuda(monkeypatch):
    """data_parallel=2 outside a torch.distributed world of 2 raises and
    names torchrun (the world-2 step is in tests/test_torch_parallel.py)."""
    with pytest.raises(RuntimeError, match="torchrun"):
        DetectorTrainer(backbone="mobilenet0.25", image_size=64,
                        data_parallel=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectorTrainer(backbone="mobilenet0.25", image_size=64)


# ------------------------------------------------------- data and scenes


def _scene(rng, h=120, w=160):
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    ann = np.zeros((2, 15), np.float32)
    for j in range(2):
        x0, y0 = rng.uniform(10, 60), rng.uniform(10, 50)
        ann[j, :4] = [x0, y0, x0 + rng.uniform(30, 80), y0 + rng.uniform(10,
                                                                         40)]
        ann[j, 4:14] = np.tile(ann[j, :2] + 5, 5) + rng.uniform(0, 20, 10)
        ann[j, 14] = 1.0 if j == 0 else -1.0
    return img, ann


@pytest.mark.parametrize("seed", range(6))
def test_preproc_matches_jax_under_seed(seed):
    """crop, distort, pad, mirror, resize and mean subtraction under one
    `random.seed`: the same image and targets as JAX's `preproc`."""
    img, ann = _scene(np.random.default_rng(seed))
    random.seed(seed)
    want = jds.preproc(img, ann, 64, 8)
    random.seed(seed)
    got = tds.preproc(img, ann, 64, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    random.seed(seed)
    np.testing.assert_array_equal(tds.preproc(img, ann, 64, 8, train=False)[0],
                                  jds.preproc(img, ann, 64, 8, train=False)[0])


def _label_tree(root, n, seed, size=96):
    d = root / "train"
    (d / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(d / "images" / f"im{i}.jpg"), img)
        lines.append(f"# im{i}.jpg")
        lines.append("10 10 40 20 12.0 12.0 0.0 45.0 12.0 0.0 28.0 22.0 "
                     "0.0 12.0 28.0 0.0 45.0 28.0 0.0 1")
        lines.append("50 60 30 12 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 "
                     "-1 -1 1")
    (d / "label.txt").write_text("\n".join(lines) + "\n")
    return d / "label.txt"


def test_license_plate_dataset_matches_jax(tmp_path):
    """`LicensePlateDetection` over a label.txt tree: the parsed labels and
    every item under one `random.seed`, as JAX's."""
    label = _label_tree(tmp_path, 3, 9)
    jd = jds.LicensePlateDetection(str(label), image_size=64)
    td = tds.LicensePlateDetection(str(label), image_size=64)
    assert td.imgs_path == jd.imgs_path and td.words == jd.words
    for i in range(3):
        random.seed(i)
        want = jd[i]
        random.seed(i)
        got = td[i]
        for k in ("image", "target"):
            np.testing.assert_array_equal(got[k], want[k])
    ann = tds.annotations_from_labels(td.words[0])
    np.testing.assert_array_equal(
        ann, jds.annotations_from_labels(jd.words[0]))
    assert ann[0, 14] == 1.0 and ann[1, 14] == -1.0


def _jax_draws(key, size):
    """The parameters `synth_scene(key, size)` draws, in the port's
    layout."""
    (kbg, knz, kw, ka, kx, ky, kv, kf, kp) = jax.random.split(key, 9)
    u = jax.random.uniform
    return dict(
        coarse=u(kbg, (8, 8, 3), minval=30.0, maxval=190.0),
        grain=jax.random.normal(knz, (size, size, 3)),
        wfrac=u(kw, minval=0.25, maxval=0.55),
        aspect=u(ka, minval=0.28, maxval=0.45),
        ux=u(kx, minval=0.03, maxval=1.0), uy=u(ky, minval=0.03, maxval=1.0),
        plate_val=u(kv, minval=190.0, maxval=250.0),
        freq=u(kf, minval=5.0, maxval=9.0),
        phase=u(kp, minval=0.0, maxval=2.0 * jnp.pi))


@pytest.mark.parametrize("size", [64, 224])
def test_synth_render_matches_jax(size):
    """`render_scenes` at the parameters JAX's keys draw against
    `synth_scene`: targets ≤1e-6, the background (bilinear upsample of the
    8×8 grid, `F.interpolate` against `jax.image.resize`, plus grain)
    ≤1e-4, and the plate and stroke masks equal (every pixel ≤1e-4)."""
    keys = jax.random.split(jax.random.PRNGKey(size), 4)
    draws = [_jax_draws(k, size) for k in keys]
    p = {k: _t(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]}
    got_img, got_t = tsynth.render_scenes(p, size)
    want = [jsynth.synth_scene(k, size) for k in keys]
    want_img = np.stack([np.asarray(w[0]) for w in want])
    want_t = np.stack([np.asarray(w[1]) for w in want])
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=1e-4)
    _, targets = tsynth.make_batch(torch.Generator().manual_seed(0), 3,
                                   size)
    assert targets.shape == (3, 4, 15) and (targets[:, 1:] == 0).all()


def test_synth_sample_statistics():
    """The sample half by its statistics (4096 scenes): every uniform in
    its range with its mean within 2%, the grain N(0, 1), the plate inside
    the canvas, the scenes in [0, 255] and each with strokes on its plate."""
    gen = torch.Generator().manual_seed(1)
    n, size = 4096, 16
    p = tsynth.sample_scenes(gen, n, size)
    ranges = dict(coarse=(30, 190), wfrac=(0.25, 0.55), aspect=(0.28, 0.45),
                  ux=(0.03, 1.0), uy=(0.03, 1.0), plate_val=(190, 250),
                  freq=(5, 9), phase=(0, 2 * np.pi))
    for k, (lo, hi) in ranges.items():
        v = p[k].numpy()
        assert v.min() >= lo and v.max() <= hi, k
        assert abs(v.mean() - (lo + hi) / 2) <= 0.02 * (hi - lo), k
    g = p["grain"].numpy()
    assert abs(g.mean()) < 0.01 and abs(g.std() - 1) < 0.01
    img, t = tsynth.render_scenes(tsynth.sample_scenes(gen, 64, 64), 64)
    assert float(img.min()) >= 0 and float(img.max()) <= 255
    assert (t[:, 0] >= 0.03).all() and (t[:, 2] <= 0.97 + 1e-6).all()
    assert ((img == 40.0).flatten(1).any(1)).all()


# ------------------------------------------- the CLI and the two scripts


def test_cli_trains_resumes_and_loads_into_plate_detector(tmp_path):
    """`main` on a label.txt tree (mobile0.25 alias, 64², batch 2): a
    reference-layout `.pth` that `PlateDetector(ckpt_path=…)` loads
    strictly with the trained weights and statistics; `--resume_net` with
    `--resume_epoch 1` fast-forwards the step and trains another epoch;
    then `eval_detector` writes one `.txt` per image and the drawn
    images."""
    from image_restoration_tpu_torch.scripts.eval_detector import \
        main as eval_main
    label = _label_tree(tmp_path, 4, 10)
    common = ["--training_dataset", str(label), "--network", "mobile0.25",
              "--image_size", "64", "--batch_size", "2", "--device", "cpu"]
    tr1 = main(common + ["--epochs", "1", "--save_folder",
                         str(tmp_path / "w1")])
    ckpt = tmp_path / "w1" / "mobilenet0.25_final.pth"
    assert ckpt.exists() and tr1.step == 2
    tr2 = main(common + ["--epochs", "2", "--resume_epoch", "1",
                         "--resume_net", str(ckpt), "--save_folder",
                         str(tmp_path / "w2")])
    assert tr2.step == 4
    final = tmp_path / "w2" / "mobilenet0.25_final.pth"
    det = PlateDetector(backbone="mobilenet0.25", image_size=64,
                        ckpt_path=str(final), device="cpu",
                        score_threshold=0.0)
    for k, v in det.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, tr2.net.state_dict()[k]), k
    imgs = tmp_path / "eval"
    imgs.mkdir()
    for i in range(2):
        cv2.imwrite(str(imgs / f"car{i}.jpg"), (np.random.default_rng(i)
                    .random((80, 120, 3)) * 255).astype(np.uint8))
    written = eval_main(["-m", str(final), "--network", "mobilenet0.25",
                         "--dataset_folder", str(imgs), "--save_folder",
                         str(tmp_path / "txt"), "--save_image",
                         "--results_folder", str(tmp_path / "res"),
                         "--confidence_threshold", "0.0",
                         "--vis_thres", "0.0", "--device", "cpu"])
    assert written == ["car0.jpg", "car1.jpg"]
    for i in range(2):
        lines = (tmp_path / "txt" / f"car{i}.txt").read_text().splitlines()
        assert lines[0] == f"car{i}" and int(lines[1]) == len(lines) - 2
        assert int(lines[1]) > 0
        assert (tmp_path / "res" / f"{i}.jpg").exists()


def test_detector_convergence_tiny_runs(tmp_path):
    """`detector_convergence --tiny` (at 8 iterations): both evaluations
    and the loss curve, finite, the report written."""
    from image_restoration_tpu_torch.scripts.detector_convergence import \
        main as conv_main
    out = tmp_path / "r.json"
    report = conv_main(["--tiny", "--iters", "8", "--chunk", "4",
                        "--out", str(out)])
    assert out.exists() and report["iters"] == 8 and \
        report["device"] == "cpu"
    assert len(report["loss_first10"]) == 8
    assert all(np.isfinite(report["loss_first10"]))
    for k in ("eval_random_init", "eval_trained"):
        assert 0 <= report[k]["mean_iou"] <= 1
        assert 0 <= report[k]["det_rate"] <= 1
