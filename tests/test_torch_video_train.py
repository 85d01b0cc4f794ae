"""The video trainers and test configs in the port, against the JAX package
where JAX decides, on the CPU.

* The TSA warm-up and `fix_flow` freeze exactly the parameters JAX's
  `_path_mask` selects (counted element by element on the flax tree),
  frozen parameters stay bit-unchanged through a step, and thaw at the
  boundary.
* `dcn_lr_mul` and `flow_lr_mul` scale exactly the updates JAX's masks
  scale, by their factor.
* `VideoRecurrentModel.test`: `flip_seq` averages the mirrored pass and
  `center_frame_only` keeps the centre frame.
* Every one of the 27 video configs resolves in the port (model, datasets,
  networks and losses built on the meta device, schedule, metrics).
* train_EDVR_L_x4_SR_REDS, train_BasicVSR_REDS, train_IconVSR_REDS and
  train_VideoRecurrentGANModel_REDS through `train_pipeline` at narrow
  widths on a tiny REDS tree, and the EDVR, BasicVSR (REDS, Vimeo), DUF
  and TOFlow test configs through `test_pipeline` on seeded `.pth` files.
"""

import glob
import os
import os.path as osp

import cv2
import jax
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.data import video_datasets as _jvd  # noqa: F401
from image_restoration_tpu.models import register_all_models
from image_restoration_tpu.models.video_models import _path_mask
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.data import video_datasets  # noqa: F401
from image_restoration_tpu_torch.losses import build_loss
from image_restoration_tpu_torch.models import build_model
from image_restoration_tpu_torch.models import video_models  # noqa: F401
from image_restoration_tpu_torch.models.lr_scheduler import build_schedule
from image_restoration_tpu_torch.scripts.generate_meta_info import (
    reds_lines, write_lines)
from image_restoration_tpu_torch.test import \
    test_pipeline as port_test_pipeline
from image_restoration_tpu_torch.train import train_pipeline
from image_restoration_tpu_torch.utils.options import parse
from image_restoration_tpu_torch.utils.registry import (DATASET_REGISTRY,
                                                        METRIC_REGISTRY,
                                                        MODEL_REGISTRY)

REPO = osp.normpath(osp.join(osp.dirname(__file__), os.pardir))
VIDEO_FAMILIES = ("BasicVSR", "EDVR", "DUF", "TOF", "VideoRecurrentGAN")
CONFIGS = [c for c in sorted(glob.glob(osp.join(REPO, "configs", "**",
                                                "*.yml"), recursive=True))
           if osp.basename(osp.dirname(c)) in VIDEO_FAMILIES]
TRAIN = osp.join(REPO, "configs", "options", "train")
TEST = osp.join(REPO, "configs", "options", "test")
EDVR_L = osp.join(TRAIN, "EDVR", "train_EDVR_L_x4_SR_REDS.yml")
ICON = osp.join(TRAIN, "BasicVSR", "train_IconVSR_REDS.yml")
BASICVSR = osp.join(TRAIN, "BasicVSR", "train_BasicVSR_REDS.yml")
NARROW_EDVR = dict(num_feat=16, num_extract_block=1, num_reconstruct_block=1,
                   deformable_groups=2, num_frame=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    register_all_models()  # JAX's registry holds every trainer the port's
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, img):
    os.makedirs(osp.dirname(path), exist_ok=True)
    cv2.imwrite(path, img)


@pytest.fixture(scope="module")
def reds(tmp_path_factory):
    """Two clips of 7 frames: GT 144×160 with LQ ×1/4 (SpyNet takes 36×40)
    and their meta file; one 2-frame 256² clip for the GAN; one 7-frame 32²
    clip for DUF and TOFlow."""
    root = tmp_path_factory.mktemp("reds")
    rng = np.random.default_rng(1900)
    for c in ("000", "001"):
        for f in range(7):
            gt = cv2.resize((rng.random((18, 20, 3)) * 255).astype(np.uint8),
                            (160, 144), interpolation=cv2.INTER_CUBIC)
            lq = cv2.resize(gt, (40, 36), interpolation=cv2.INTER_AREA)
            _write(str(root / "gt" / c / f"{f:08d}.png"), gt)
            _write(str(root / "lq" / c / f"{f:08d}.png"), lq)
    # one 7-frame clip at 32² (LQ 8², and LQ 8² upscaled to 32²) for DUF
    # and TOFlow
    for f in range(7):
        gt = cv2.resize((rng.random((8, 8, 3)) * 255).astype(np.uint8),
                        (32, 32), interpolation=cv2.INTER_CUBIC)
        lq = cv2.resize(gt, (8, 8), interpolation=cv2.INTER_AREA)
        _write(str(root / "gt32" / "000" / f"{f:08d}.png"), gt)
        _write(str(root / "lq8" / "000" / f"{f:08d}.png"), lq)
        _write(str(root / "lq8up" / "000" / f"{f:08d}.png"),
               cv2.resize(lq, (32, 32), interpolation=cv2.INTER_CUBIC))
    write_lines(reds_lines(str(root / "gt")), str(root / "meta.txt"))
    # one clip of 2 frames at 256² (LQ 64²) for the GAN config's 256² D
    for f in range(2):
        gt = cv2.resize((rng.random((16, 16, 3)) * 255).astype(np.uint8),
                        (256, 256), interpolation=cv2.INTER_CUBIC)
        _write(str(root / "gt256" / "000" / f"{f:08d}.png"), gt)
        _write(str(root / "lq64" / "000" / f"{f:08d}.png"),
               cv2.resize(gt, (64, 64), interpolation=cv2.INTER_AREA))
    write_lines(reds_lines(str(root / "gt256")), str(root / "meta256.txt"))
    return root


def _opt(cfg, root, overrides, is_train=True):
    opt = parse(cfg, root_path=str(root), is_train=is_train)
    for keys, value in overrides.items():
        node = opt
        *parents, leaf = keys.split(":")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return opt


def _model(cfg, root, net, **train):
    over = {f"network_g:{k}": v for k, v in net.items()}
    over.update({f"train:{k}": v for k, v in train.items()})
    over["path:pretrain_network_g"] = None
    return build_model(_opt(cfg, root, over), device="cpu")


def _trainable_elements_jax(opt, pred):
    """Σ sizes of the flax leaves JAX's `_path_mask(pred)` leaves True."""
    net = jax_build(opt)
    n, t = 1, opt.get("num_frame", 3)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((n, t, 64, 64, 3),
                                                 np.float32))
    mask = _path_mask(shapes["params"], pred)
    leaves = jax.tree.leaves(jax.tree.map(
        lambda s, m: s.size if m else 0, shapes["params"], mask))
    return sum(leaves)


def _clip_batch(seed, n=1, t=3, h=16, w=16, scale=4):
    rng = np.random.default_rng(seed)
    return {"lq": rng.random((n, t, h, w, 3)).astype(np.float32),
            "gt": rng.random((n, h * scale, w * scale, 3)).astype(
                np.float32)}


def test_tsa_warmup_freezes_jax_mask_and_thaws(tmp_path):
    """Below `tsa_iter` the trainable elements are those of JAX's mask (any
    path segment holding 'fusion'); a warm-up step moves only `fusion.*`;
    from `tsa_iter` on everything trains."""
    model = _model(EDVR_L, tmp_path, NARROW_EDVR, tsa_iter=2)
    net_opt = dict(model.opt["network_g"])
    want = _trainable_elements_jax(net_opt, lambda p: any(
        "fusion" in seg for seg in p))
    before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.optimize_parameters(1, _clip_batch(1901))
    got = sum(p.numel() for p in model.net_g.parameters() if p.requires_grad)
    assert got == want > 0
    for k, v in model.net_g.state_dict().items():
        moved = not torch.equal(v, before[k])
        assert moved == k.startswith("fusion."), k
    model.optimize_parameters(2, _clip_batch(1902))
    assert all(p.requires_grad for p in model.net_g.parameters())
    assert not torch.equal(model.net_g.state_dict()["conv_first.weight"],
                           before["conv_first.weight"])


def test_fix_flow_freezes_jax_mask(tmp_path):
    """IconVSR below `fix_flow`: JAX's mask (no segment holding 'spynet' or
    'edvr') trains the same elements, and SpyNet and the EDVR extractor
    stay bit-unchanged through a step."""
    net = dict(num_feat=16, num_block=1, temporal_padding=1,
               spynet_path=None, edvr_path=None)
    model = _model(ICON, tmp_path, net, fix_flow=3)
    want = _trainable_elements_jax(dict(model.opt["network_g"]), lambda p: not
                                   any("spynet" in s or "edvr" in s
                                       for s in p))
    before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    model.optimize_parameters(1, _clip_batch(1903, h=36, w=40) |
                              {"gt": np.random.default_rng(1904).random(
                                  (1, 3, 144, 160, 3)).astype(np.float32)})
    got = sum(p.numel() for p in model.net_g.parameters() if p.requires_grad)
    assert got == want > 0
    for k, v in model.net_g.state_dict().items():
        frozen = k.startswith(("spynet.", "edvr."))
        assert torch.equal(v, before[k]) == frozen, k


@pytest.mark.parametrize("kind", ["dcn", "flow"])
def test_lr_multipliers_scale_exactly_the_masked_updates(tmp_path, kind):
    """One step from the same weights and batch with the multiplier and
    without: the updates of the parameters JAX's mask selects (any segment
    holding 'dcn'; the top-level 'spynet') are the factor times the
    others'; every other update is equal."""
    if kind == "dcn":
        cfg, net, mul_key, mul = EDVR_L, NARROW_EDVR, "dcn_lr_mul", 0.25
        batch = _clip_batch(1905)
        selected = lambda k: "dcn" in k  # noqa: E731
        extra = {"tsa_iter": 0}
    else:
        cfg, mul_key, mul = BASICVSR, "flow_lr_mul", 0.125
        net = dict(num_feat=8, num_block=1, spynet_path=None)
        batch = _clip_batch(1906, h=36, w=40)
        batch["gt"] = np.random.default_rng(1907).random(
            (1, 3, 144, 160, 3)).astype(np.float32)
        selected = lambda k: k.startswith("spynet.")  # noqa: E731
        extra = {"fix_flow": None}
    deltas = []
    for m in (1.0, mul):
        model = _model(cfg, tmp_path, net, **{mul_key: m}, **extra)
        p0 = {k: v.clone() for k, v in model.net_g.named_parameters()}
        p_max = {k: float(v.abs().max()) for k, v in p0.items()}
        model.optimize_parameters(10, batch)
        deltas.append({k: v.detach() - p0[k]
                       for k, v in model.net_g.named_parameters()})
    n_sel = 0
    for k, d1 in deltas[0].items():
        d = deltas[1][k]
        if selected(k):
            n_sel += 1
            # each delta is a difference of float32 weights: up to an ulp
            # of the weight off the update
            ulp = float(torch.finfo(torch.float32).eps * d1.new_tensor(
                1.0).max() * p_max[k])
            assert torch.allclose(d, mul * d1, rtol=1e-5, atol=2 * ulp), k
        else:
            assert torch.equal(d, d1), k
    assert n_sel > 0


def test_flip_seq_and_center_frame_only(tmp_path):
    """`val.flip_seq` runs the clip mirrored to 2T frames and averages
    frame i with frame 2T−1−i; `center_frame_only` keeps frame T // 2."""
    opt = _opt(osp.join(TEST, "BasicVSR", "test_BasicVSR_Vimeo90K_BIx4.yml"),
               tmp_path, {"network_g:num_feat": 8, "network_g:num_block": 1,
                          "network_g:spynet_path": None,
                          "path:pretrain_network_g": None}, is_train=False)
    model = build_model(opt, device="cpu")
    lq = np.random.default_rng(1908).random((1, 3, 36, 40, 3)).astype(
        np.float32)
    got = model.test(lq)
    with torch.no_grad():
        x = torch.from_numpy(lq)
        out = model.net_g_ema(torch.cat([x, x.flip(1)], 1))
    want = 0.5 * (out[:, :3] + out[:, 3:].flip(1))
    assert got.shape == (1, 144, 160, 3)
    assert torch.allclose(got, want[:, 1], atol=1e-6)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: osp.splitext(
    osp.basename(c))[0])
def test_video_config_resolves_in_the_port(cfg):
    """The config parses and every `type:` it names is the port's: model,
    datasets, networks (built on the meta device, no pretrained `.pth`),
    losses, schedule and metrics."""
    opt = parse(cfg, root_path=REPO, is_train="train" in osp.basename(cfg))
    MODEL_REGISTRY.get(opt["model_type"])
    for ds in (opt.get("datasets") or {}).values():
        DATASET_REGISTRY.get(ds["type"])
    train_opt = opt.get("train") or {}
    with torch.device("meta"):
        for key, net_opt in opt.items():
            if key.startswith("network_") and isinstance(net_opt, dict):
                net_opt = dict(net_opt)
                for k in ("spynet_path", "edvr_path"):
                    if k in net_opt:
                        net_opt[k] = None
                build_network(net_opt)
        for key, sub in train_opt.items():
            if key.endswith("_opt") and isinstance(sub, dict) \
                    and "type" in sub:
                build_loss(sub)
    if train_opt:
        assert build_schedule(train_opt, 1e-4)(0) > 0
    for m in ((opt.get("val") or {}).get("metrics") or {}).values():
        METRIC_REGISTRY.get(m["type"])


def test_video_config_count():
    fams = [osp.basename(osp.dirname(c)) for c in CONFIGS]
    assert len(CONFIGS) == 27
    assert [fams.count(f) for f in VIDEO_FAMILIES] == [12, 12, 1, 1, 1]


# ------------------------------------------------- train and test configs

def _common(reds, num_frame=3):
    return ["logger:use_tb_logger=false", "logger:print_freq=1",
            "train:total_iter=2", "logger:save_checkpoint_freq=0",
            f"datasets:train:dataroot_gt={reds}/gt",
            f"datasets:train:dataroot_lq={reds}/lq",
            f"datasets:train:meta_info_file={reds}/meta.txt",
            "datasets:train:val_partition=[]",
            "datasets:train:batch_size_per_gpu=1",
            f"datasets:train:num_frame={num_frame}",
            f"datasets:val:dataroot_gt={reds}/gt",
            f"datasets:val:dataroot_lq={reds}/lq",
            "datasets:val:meta_info_file=~"]


TRAIN_RUNS = {
    "EDVR/train_EDVR_L_x4_SR_REDS.yml": [
        "network_g:num_feat=16", "network_g:num_extract_block=1",
        "network_g:num_reconstruct_block=1", "network_g:deformable_groups=2",
        "network_g:num_frame=3", "datasets:val:num_frame=3",
        "datasets:train:gt_size=64", "path:pretrain_network_g=~",
        "train:tsa_iter=2"],
    "BasicVSR/train_BasicVSR_REDS.yml": [
        "network_g:num_feat=8", "network_g:num_block=1",
        "network_g:spynet_path=~", "datasets:train:gt_size=144",
        "train:fix_flow=2"],
    "BasicVSR/train_IconVSR_REDS.yml": [
        "network_g:num_feat=16", "network_g:num_block=1",
        "network_g:temporal_padding=1", "network_g:spynet_path=~",
        "network_g:edvr_path=~", "datasets:train:gt_size=144",
        "train:fix_flow=2"],
    "VideoRecurrentGAN/train_VideoRecurrentGANModel_REDS.yml": [
        "network_g:num_feat=8", "network_g:num_block=1",
        "network_g:spynet_path=~", "network_d:num_feat=8",
        "datasets:train:gt_size=256", "datasets:train:num_frame=2",
        "train:perceptual_opt:layer_weights={conv1_2: 1}",
        "path:pretrain_network_g=~"],
}


@pytest.mark.parametrize("cfg", list(TRAIN_RUNS), ids=lambda c: osp.basename(
    c)[6:-4])
def test_video_train_config_runs(reds, tmp_path, cfg):
    """The config as written but for its dataroots, the pretrained paths,
    narrow widths, 2 steps, 3 frames (the GAN: 2 frames of 256², its D's
    size, and VGG19 to conv1_2 only): every
    loss finite, a per-folder PSNR, `net_g_2.pth` in the reference
    layout."""
    common = _common(reds)
    if "GAN" in cfg:  # its 256² D: the 256² clip
        common = [c.replace("/gt", "/gt256").replace("/lq", "/lq64")
                  .replace("meta.txt", "meta256.txt") for c in common]
    model = train_pipeline(str(tmp_path), argv=[
        "-opt", osp.join(TRAIN, cfg), "--force_yml", *common,
        *TRAIN_RUNS[cfg]], device="cpu")
    assert model.iter == 2
    assert model.log_dict and all(np.isfinite(v)
                                  for v in model.log_dict.values())
    sd = torch.load(osp.join(model.opt["path"]["models"], "net_g_2.pth"),
                    weights_only=True)["params"]
    assert "conv_last.weight" in sd


TEST_RUNS = {  # config: (network overrides, GT folder, LQ folder)
    "EDVR/test_EDVR_L_x4_SR_REDS.yml": (dict(NARROW_EDVR), "gt", "lq"),
    "BasicVSR/test_BasicVSR_REDS.yml": (dict(num_feat=8, num_block=1,
                                             spynet_path=None), "gt", "lq"),
    "DUF/test_DUF_official.yml": (dict(num_layer=16), "gt32", "lq8"),
    "TOF/test_TOF_official.yml": ({}, "gt32", "lq8up"),
}


@pytest.mark.parametrize("cfg", list(TEST_RUNS), ids=lambda c: osp.basename(
    c)[5:-4])
def test_video_test_config_runs(reds, tmp_path, cfg):
    """The test config on the tiny clips with a seeded narrow `.pth`: a
    finite PSNR per folder (`{folder}/psnr`)."""
    net_over, gt, lq = TEST_RUNS[cfg]
    opt = parse(osp.join(TEST, cfg), root_path=str(tmp_path), is_train=False)
    net_opt = dict(opt["network_g"], **net_over)
    pth = str(tmp_path / "net_g.pth")
    torch.save({"params": build_network(
        net_opt, torch.Generator().manual_seed(1910)).state_dict()}, pth)
    sets = []
    for key in opt["datasets"]:
        sets += [f"datasets:{key}:dataroot_gt={reds}/{gt}",
                 f"datasets:{key}:dataroot_lq={reds}/{lq}",
                 f"datasets:{key}:meta_info_file=~"]
        if "EDVR" in cfg:
            sets.append(f"datasets:{key}:num_frame=3")
    res = port_test_pipeline(str(tmp_path), argv=[
        "-opt", osp.join(TEST, cfg), "--force_yml", *sets,
        f"path:pretrain_network_g={pth}",
        *[f"network_g:{k}={'~' if v is None else v}"
          for k, v in net_over.items()]], device="cpu")
    (metrics,) = res.values()
    assert sorted({k.split("/")[0] for k in metrics}) == sorted(
        os.listdir(reds / gt))
    assert all(np.isfinite(v) for v in metrics.values())
