"""Port plate detector against the JAX package on the CPU: RetinaFace with
each backbone, the weight converters both ways, priors, decoding, NMS and
`PlateDetector`. The same weights (made from a numpy seed in the reference
key layout, carried into flax by the JAX importer `load_torch_retinaface`)
and the same inputs go to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.convert.retinaface_import import (
    load_torch_retinaface)
from image_restoration_tpu.detect import box_utils as jbu
from image_restoration_tpu.detect import config as jcfg
from image_restoration_tpu.detect.engine import PlateDetector as JaxDetector
from image_restoration_tpu.detect.priors import prior_box as jax_prior_box
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import retinaface_state_dict_from_jax
from image_restoration_tpu_torch.detect import box_utils as tbu
from image_restoration_tpu_torch.detect import config as tcfg
from image_restoration_tpu_torch.detect.engine import PlateDetector
from image_restoration_tpu_torch.detect.priors import prior_box


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: several test workers
    share the cores, and more threads a worker make them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX golden's (tests/test_detect.py)
BACKBONES = {"Resnet18": 256, "Resnet50": 256, "mobilenet0.25": 64,
             "MobilenetV3": 256}


def seeded_state_dict(net, seed):
    """numpy weights for every key of the port net: convs at their LeCun
    init, BN scale U(0.5, 1), biases and means N(0, 0.1), variances
    U(0.5, 1.5), so activations stay in a sane range."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if v.dim() == 4:
            fan_in = v[0].numel()
            a = rng.standard_normal(v.shape) / np.sqrt(fan_in)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("weight"):
            a = rng.uniform(0.5, 1.0, v.shape)
        else:
            a = rng.normal(0.0, 0.1, v.shape)
        sd[k] = a.astype(np.float32)
    return sd


def port_and_jax(backbone, size, seed=0):
    """(port net, flax net, flax variables) holding the same weights."""
    oc = BACKBONES[backbone]
    opt = dict(type="RetinaFace", backbone=backbone, out_channel=oc,
               phase="test")
    tnet = build_network(opt).eval()
    sd = seeded_state_dict(tnet, seed)
    tnet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    jnet = jax_build(opt)
    tmpl = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x),
                          jnp.zeros((1, size, size, 3)))
    return tnet, jnet, load_torch_retinaface(sd, tmpl), sd


@pytest.mark.parametrize("backbone,size", [
    ("Resnet18", 64), ("Resnet18", 80), ("Resnet50", 64),
    ("mobilenet0.25", 64), ("MobilenetV3", 64)])
def test_retinaface_matches_jax(backbone, size):
    """loc, conf (softmax) and landm within the JAX golden's 2e-4. At 80²
    layer4 (3²) is upsampled to layer3 (5²) by FPN's half-pixel nearest
    branch; the flax variables convert back to the same state_dict."""
    tnet, jnet, variables, sd = port_and_jax(backbone, size)
    back = retinaface_state_dict_from_jax(tnet, variables)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    img = np.random.default_rng(1).random((2, size, size, 3)).astype(
        np.float32) * 255 - 120
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables,
                                                               img)
    with torch.no_grad():
        got = tnet(torch.from_numpy(img))
    n_priors = prior_box(tcfg.get_cfg(backbone), (size, size)).shape[0]
    for name, g, w, k in zip(("loc", "conf", "landm"), got, want, (4, 2, 10)):
        assert g.shape == (2, n_priors, k), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_retinaface_reference_key_names():
    """The port's keys are the reference checkpoint's (the names the JAX
    importer maps), and MobilenetV3's are the JAX module names."""
    keys = {}
    for bb in BACKBONES:
        keys[bb] = set(build_network(dict(
            type="RetinaFace", backbone=bb, out_channel=BACKBONES[bb],
            phase="test")).state_dict())
    for bb, k in [("Resnet18", "body.layer2.0.downsample.0.weight"),
                  ("Resnet18", "body.layer4.1.bn2.running_mean"),
                  ("Resnet50", "body.layer3.5.conv3.weight"),
                  ("mobilenet0.25", "body.stage1.0.0.weight"),
                  ("mobilenet0.25", "body.stage2.3.4.running_var"),
                  ("mobilenet0.25", "body.stage3.1.3.weight"),
                  ("Resnet18", "fpn.output1.0.weight"),
                  ("Resnet18", "fpn.merge2.1.bias"),
                  ("Resnet18", "ssh1.conv3X3.1.bias"),
                  ("Resnet18", "ssh3.conv7x7_3.0.weight"),
                  ("Resnet18", "ClassHead.0.conv1x1.weight"),
                  ("Resnet18", "LandmarkHead.2.conv1x1.bias"),
                  ("MobilenetV3", "body.block0_pw1.weight"),
                  ("MobilenetV3", "body.stem_bn.running_mean")]:
        assert k in keys[bb], (bb, k)
    assert not any("stage" in k for k in keys["MobilenetV3"])


def test_plate_detector_matches_jax_and_loads_pth(tmp_path):
    """A reference-style `.pth` ('state_dict', `module.` prefix, classifier
    keys and num_batches_tracked, which both loaders drop) goes into the
    JAX PlateDetector through `load_torch_retinaface` and into the port's
    strictly; at image_size 64, score threshold 0 and keep_top_k 5 `valid`
    is equal and the rest within 2e-4."""
    tnet, _, _, sd = port_and_jax("Resnet18", 64, seed=2)
    ckpt = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    ckpt["module.body.fc.weight"] = torch.zeros(10, 512)
    ckpt["module.body.fc.bias"] = torch.zeros(10)
    for k in tnet.state_dict():
        if k.endswith("num_batches_tracked"):
            ckpt[f"module.{k}"] = torch.tensor(7)
    path = str(tmp_path / "Resnet18_Final.pth")
    torch.save({"state_dict": ckpt}, path)

    kw = dict(backbone="Resnet18", image_size=64, score_threshold=0.0,
              keep_top_k=5)
    jdet = JaxDetector(ckpt_path=path, **kw)
    tdet = PlateDetector(ckpt_path=path, device="cpu", **kw)
    img = (np.random.default_rng(3).random((2, 64, 64, 3)) * 255).astype(
        np.float32)
    want, got = jdet(img), tdet(img)
    for name, g, w in zip(("boxes", "scores", "landms", "valid"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "valid":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    assert got[3].any()
    # detect_image: resize to 64², detect, scale back to pixels
    full = (np.random.default_rng(4).random((300, 400, 3)) * 255).astype(
        np.uint8)
    b, s, lm, v = tdet.detect_image(full)
    assert b.shape == (5, 4) and s.shape == (5,) and lm.shape == (5, 10)
    assert v.shape == (5,) and v.dtype == bool
    jb, _, jl, _ = jdet.detect_image(full)
    np.testing.assert_allclose(b, jb, rtol=2e-4, atol=0.1)
    np.testing.assert_allclose(lm, jl, rtol=2e-4, atol=0.1)


def test_plate_detector_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlateDetector(image_size=64)


@pytest.mark.parametrize("name", ["mobilenet0.25", "Resnet18", "resnet50",
                                  "MobilenetV3", "mobilenetv3"])
def test_prior_box_and_config_equal(name):
    assert tcfg.get_cfg(name) == jcfg.get_cfg(name)
    for size in [(224, 224), (80, 64)]:
        np.testing.assert_array_equal(prior_box(tcfg.get_cfg(name), size),
                                      jax_prior_box(jcfg.get_cfg(name), size))
    assert prior_box(tcfg.cfg_re18, (224, 224)).shape == (2058, 4)


def test_decode_matches_jax(rng):
    priors = prior_box(tcfg.cfg_re18, (224, 224))
    var = tcfg.cfg_re18["variance"]
    loc = rng.standard_normal((2, len(priors), 4)).astype(np.float32) * 0.3
    landm = rng.standard_normal((2, len(priors), 10)).astype(np.float32) * .3
    tp = torch.from_numpy(priors)
    got = tbu.decode(torch.from_numpy(loc), tp, var).numpy()
    got_l = tbu.decode_landm(torch.from_numpy(landm), tp, var).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(jbu.decode(
            jnp.asarray(loc[i]), jnp.asarray(priors), jnp.asarray(var))),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_l[i], np.asarray(jbu.decode_landm(
            jnp.asarray(landm[i]), jnp.asarray(priors), jnp.asarray(var))),
            rtol=0, atol=1e-6)


def _nms_cases(rng):
    n = 60
    centers = rng.random((2, n, 2)).astype(np.float32)
    wh = rng.random((2, n, 2)).astype(np.float32) * 0.3 + 0.02
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    yield "random", boxes, rng.random((2, n)).astype(np.float32)
    # ties: scores on a 0.1 grid; zero-area boxes (0/0 = NaN IoU)
    tied = np.round(rng.random((2, n)) * 5).astype(np.float32) / 10
    degenerate = boxes.copy()
    degenerate[:, ::7, 2:] = degenerate[:, ::7, :2]
    yield "ties", degenerate, tied
    yield "all-equal", boxes, np.full((2, n), 0.5, np.float32)


@pytest.mark.parametrize("top_k,iou,score_thr", [(200, 0.6, 0.0),
                                                 (25, 0.3, 0.2)])
def test_nms_matches_jax(rng, top_k, iou, score_thr):
    """Keep mask and order exactly equal to `nms_jax`, image by image, on
    random boxes, tied scores and zero-area boxes; the whole batch in one
    call."""
    for case, boxes, scores in _nms_cases(rng):
        kb, ks, keep, order = tbu.nms(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), iou, top_k,
                                      score_thr)
        for i in range(2):
            jb, js, jk, jo = jbu.nms_jax(jnp.asarray(boxes[i]),
                                         jnp.asarray(scores[i]), iou, top_k,
                                         score_thr)
            np.testing.assert_array_equal(order[i].numpy(), np.asarray(jo),
                                          err_msg=case)
            np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk),
                                          err_msg=case)
            np.testing.assert_array_equal(kb[i].numpy(), np.asarray(jb))
            np.testing.assert_array_equal(ks[i].numpy(), np.asarray(js))


def test_jaccard_and_py_cpu_nms_match_jax(rng):
    a = np.sort(rng.random((7, 4)).astype(np.float32), axis=-1)[:, [0, 1, 2, 3]]
    a = np.concatenate([a[:, :2], a[:, :2] + a[:, 2:]], -1)
    a[3, 2:] = a[3, :2]  # zero area
    got = tbu.jaccard(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    want = np.asarray(jbu.jaccard(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.isnan(got[3, 3]) and np.isnan(want[3, 3])
    dets = np.concatenate([a * 100, rng.random((7, 1))], 1).astype(np.float32)
    assert tbu.py_cpu_nms(dets, 0.3) == jbu.py_cpu_nms(dets, 0.3)
