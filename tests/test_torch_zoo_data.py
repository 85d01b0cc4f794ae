"""The data preparation that feeds the image zoo, and the zoo's configs, in
the port against the JAX package on the CPU.

* `ops.resize.imresize` (MATLAB's bicubic) against JAX's at scales 1/2,
  1/3, 1/4, 2, 3 and 4, antialiased and not: 1e-5 of max|ref|; the weight
  matrices equal.
* `scripts/matlab_scripts.py`: `generate_bicubic`, back-projection and
  reverse filtering against JAX's script functions on 48² images (floats
  within 1e-5 of max|ref|); the port writes MATLAB's rounded levels, JAX's
  script truncated ones (the finding: its sets sit half a level low).
* `scripts/extract_subimages.py`: counts, names, the tail crop and GT↔LQ
  pairing on DIV2K's naming; JAX's script on the same tree writes LR names
  that its own `PairedImageDataset` never finds (the finding).
* `scripts/prepare_hifacegan_dataset.py`: every template bit-equal to
  JAX's script under one seed, with its shapes and dtypes.
* Every non-video config under `configs/` resolves in the port: model,
  datasets, networks (built on the meta device), losses, schedule and
  metrics, as `tests/test_option_zoo.py:25-61` checks JAX's.
* The EDSR-L and RCAN train configs through `train_pipeline` for 2 steps on
  sets made by the scripts above (RCAN ×2 as written fails at its first
  loss, `upscale: 4` at `scale: 2`, as it does under JAX), and
  `test_MSRResNet_x4.yml` and its `_woGT` twin through `test_pipeline`, at
  narrow widths.
"""

import glob
import importlib.util
import os
import os.path as osp
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.data import datasets as jax_datasets
from image_restoration_tpu.ops import resize as jresize
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.losses import build_loss
from image_restoration_tpu_torch.models.lr_scheduler import build_schedule
from image_restoration_tpu_torch.ops import resize as tresize
from image_restoration_tpu_torch.scripts import extract_subimages as tsub
from image_restoration_tpu_torch.scripts import matlab_scripts as tmat
from image_restoration_tpu_torch.scripts import \
    prepare_hifacegan_dataset as thiface
from image_restoration_tpu_torch.test import \
    test_pipeline as port_test_pipeline
from image_restoration_tpu_torch.train import train_pipeline
from image_restoration_tpu_torch.utils.options import parse
from image_restoration_tpu_torch.utils.registry import (DATASET_REGISTRY,
                                                        LOSS_REGISTRY,
                                                        METRIC_REGISTRY,
                                                        MODEL_REGISTRY)

REPO = osp.normpath(osp.join(osp.dirname(__file__), os.pardir))
VIDEO_FAMILIES = {"BasicVSR", "EDVR", "DUF", "TOF", "VideoRecurrentGAN"}
CONFIGS = [c for c in sorted(glob.glob(osp.join(REPO, "configs", "**",
                                                "*.yml"), recursive=True))
           if osp.basename(osp.dirname(c)) not in VIDEO_FAMILIES]
EDSR_L = "configs/options/train/EDSR/train_EDSR_Lx4.yml"
RCAN_X2 = "configs/options/train/RCAN/train_RCAN_x2.yml"
MSR_TEST = "configs/options/test/SRResNet_SRGAN/test_MSRResNet_x4.yml"
MSR_TEST_WOGT = \
    "configs/options/test/SRResNet_SRGAN/test_MSRResNet_x4_woGT.yml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _jax_script(name, rel):
    """A JAX-side script under scripts/ as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", osp.join(REPO, "scripts", rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _photo(h, w, seed):
    """A smooth seeded BGR uint8 image with edges (bicubic sees both)."""
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.random((h // 8 + 2, w // 8 + 2, 3)).astype(
        np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img * 220 + 20, 0, 255)
    img[h // 3:h // 2, w // 4:w // 2] = rng.integers(0, 256, 3)
    return img.astype(np.uint8)


# ----------------------------------------------------------------- imresize

@pytest.mark.parametrize("antialiasing", [True, False])
@pytest.mark.parametrize("scale", [1 / 2, 1 / 3, 1 / 4, 2, 3, 4],
                         ids=["1/2", "1/3", "1/4", "2", "3", "4"])
def test_imresize_matches_jax(scale, antialiasing):
    """Batch of two 48×40 images: output size ceil(h·scale), values within
    1e-5 of max|ref|, the weight matrices equal."""
    x = np.random.default_rng(1500).random((2, 48, 40, 3)).astype(
        np.float32)
    want = np.asarray(jresize.imresize(jnp.asarray(x), scale, antialiasing))
    got = tresize.imresize(torch.from_numpy(x), scale, antialiasing).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5
    oh = want.shape[1]
    np.testing.assert_array_equal(
        tresize.matlab_resize_matrix(48, oh, antialiasing),
        jresize.matlab_resize_matrix(48, oh, antialiasing))
    hwc = tresize.imresize(torch.from_numpy(x[0]), scale, antialiasing)
    assert torch.equal(hwc, torch.from_numpy(got[0]))


# ---------------------------------------------------------- matlab_scripts

@pytest.fixture(scope="module")
def jax_matlab():
    return _jax_script("matlab_scripts", "matlab_scripts.py")


def _write(folder, name, img):
    os.makedirs(folder, exist_ok=True)
    cv2.imwrite(osp.join(folder, name), img)


def test_generate_bicubic_matches_jax(jax_matlab, tmp_path):
    """Two 52×50 photos mod-cropped to 48² at mod 12, LR ×1/4 and the
    bicubic-up image: the crop equal, the LR and up levels the round of
    JAX's floats (truncated by JAX's script: JAX's PNGs are 0 or 1 level
    below the port's, half a level on average)."""
    src = tmp_path / "src"
    for i in range(2):
        _write(str(src), f"im{i}.png", _photo(52, 50, 1501 + i))
    out = {side: {k: str(tmp_path / side / k) for k in ("mod", "lr", "bic")}
           for side in ("port", "jax")}
    assert tmat.generate_bicubic(str(src), out["port"]["mod"],
                                 out["port"]["lr"], out["port"]["bic"],
                                 12, 4, device="cpu") == 2
    jax_matlab.generate_bicubic(str(src), out["jax"]["mod"],
                                out["jax"]["lr"], out["jax"]["bic"], 12, 4)
    lows = []
    for i in range(2):
        name = f"im{i}.png"
        rd = {side: {k: cv2.imread(osp.join(d, name)).astype(np.int32)
                     for k, d in out[side].items()} for side in out}
        assert rd["port"]["mod"].shape == (48, 48, 3)
        np.testing.assert_array_equal(rd["port"]["mod"], rd["jax"]["mod"])
        mod = rd["port"]["mod"].astype(np.float32) / 255.0
        lr = jresize.imresize(jnp.asarray(mod)[None], 1 / 4)[0]
        floats = {"lr": np.asarray(lr), "bic": np.asarray(
            jresize.imresize(lr[None], 4.0)[0])}
        for k, f in floats.items():
            want = np.clip(np.round(f * 255.0), 0, 255)
            near_half = np.abs(f * 255.0 - np.floor(f * 255.0) - 0.5) < 1e-3
            assert np.all((rd["port"][k] == want) | near_half), k
            diff = rd["port"][k] - rd["jax"][k]
            assert set(np.unique(diff)) <= {0, 1}, k
            lows.append(diff.mean())
    assert rd["port"]["lr"].shape == (12, 12, 3)
    assert rd["port"]["bic"].shape == (48, 48, 3)
    assert 0.3 < float(np.mean(lows)) < 0.7, lows


def test_backprojection_and_reverse_filter_match_jax(jax_matlab, tmp_path):
    """Both iterations (20 steps) on a 48² image and its ×1/4 LR: floats
    within 1e-5 of max|ref| of JAX's scan; the CLI's PNGs within one level
    of JAX's run_folder (rounded against truncated)."""
    hr = _photo(48, 48, 1503).astype(np.float32) / 255.0
    lr = np.array(jresize.imresize(jnp.asarray(hr)[None], 1 / 4)[0])
    pre = np.clip(hr + np.random.default_rng(1504).normal(
        0, 0.02, hr.shape).astype(np.float32), 0, 1)
    want = np.asarray(jax_matlab.backprojection(jnp.asarray(pre),
                                                jnp.asarray(lr), 20))
    got = tmat.backprojection(torch.from_numpy(pre), torch.from_numpy(lr),
                              20).numpy()
    assert _rel(got, want) <= 1e-5
    want = np.asarray(jax_matlab.reverse_filter(jnp.asarray(pre),
                                                jnp.asarray(lr), 4, 20))
    got = tmat.reverse_filter(torch.from_numpy(pre), torch.from_numpy(lr),
                              4, 20).numpy()
    assert _rel(got, want) <= 1e-5
    _write(str(tmp_path / "lr"), "a.png", tmat.to_uint8(lr))
    _write(str(tmp_path / "pre"), "a.png", tmat.to_uint8(pre))
    for mode in ("bp", "reverse_filter"):
        port_dir, jax_dir = (str(tmp_path / f"{mode}_{s}")
                             for s in ("port", "jax"))
        assert tmat.main(["--device", "cpu", mode, "--lr_folder",
                          str(tmp_path / "lr"), "--preout_folder",
                          str(tmp_path / "pre"), "--save_folder", port_dir,
                          "--max_iter", "5"]) == 1
        jax_matlab.run_folder(mode, str(tmp_path / "lr"),
                              str(tmp_path / "pre"), jax_dir, 5, 4)
        a, b = (cv2.imread(osp.join(d, "a.png")).astype(np.int32)
                for d in (port_dir, jax_dir))
        assert np.abs(a - b).max() <= 1, mode


def test_device_entry_points_default_to_cuda():
    """Unset, the device is cuda, which raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from image_restoration_tpu_torch.convert import load_dfdnet_dict
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmat.generate_bicubic("unused", None, None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmat.run_folder("bp", "unused", "unused", "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_dfdnet_dict({})


# ------------------------------------------------------- extract_subimages

def _div2k_tree(root, n=2, hw=(76, 100)):
    """n DIV2K-named pairs: HR `000i.png` the nearest ×4 of LR
    `000ix4.png`, so a GT crop is exactly its LQ crop upsampled."""
    h, w = hw
    for i in range(1, n + 1):
        lr = _photo(h // 4, w // 4, 1510 + i)
        _write(f"{root}/HR", f"{i:04d}.png", np.kron(
            lr, np.ones((4, 4, 1), np.uint8)))
        _write(f"{root}/X4", f"{i:04d}x4.png", lr)


def test_extract_subimages_pairs_on_div2k_names(tmp_path):
    """HR 76×100 at 48/24 and its ×4 LR at 12/6: 3×4 crops each (the tail
    crops at 28 and 52, 7 and 13 included), named `0001_s001.png`…; every
    GT sub-image has its LQ partner under `filename_tmpl: '{}'` in the
    port's PairedImageDataset and is that partner ×4."""
    root = str(tmp_path)
    _div2k_tree(root)
    assert tsub.extract_subimages(f"{root}/HR", f"{root}/HR_sub", 48, 24,
                                  n_thread=2) == 24
    assert tsub.main(["--input", f"{root}/X4", "--output", f"{root}/X4_sub",
                      "--crop_size", "12", "--step", "6"]) == 24
    names = sorted(os.listdir(f"{root}/HR_sub"))
    assert names == sorted(os.listdir(f"{root}/X4_sub"))
    assert names[:2] == ["0001_s001.png", "0001_s002.png"]
    assert names[-1] == "0002_s012.png"
    np.testing.assert_array_equal(tsub.crop_starts(76, 48, 24), [0, 24, 28])
    np.testing.assert_array_equal(tsub.crop_starts(100, 48, 24),
                                  [0, 24, 48, 52])
    np.testing.assert_array_equal(tsub.crop_starts(76, 48, 24, 4), [0, 24])
    ds = build_dataset(dict(type="PairedImageDataset", phase="val", scale=4,
                            dataroot_gt=f"{root}/HR_sub",
                            dataroot_lq=f"{root}/X4_sub",
                            filename_tmpl="{}"))
    assert len(ds) == 24
    for i in range(len(ds)):
        item = ds[i]
        up = np.kron(item["lq"], np.ones((4, 4, 1), np.float32))
        np.testing.assert_array_equal(up, item["gt"])
    with pytest.raises(FileExistsError):
        tsub.extract_subimages(f"{root}/HR", f"{root}/HR_sub", 48, 24)


def test_jax_extract_subimages_does_not_pair(tmp_path, monkeypatch):
    """The finding: JAX's script keeps DIV2K's LR suffix (`0001x4_s001.png`)
    and drops the tail crops (2×3 per image here, not 3×4), so JAX's
    `PairedImageDataset` with the zoo's `filename_tmpl: '{}'` names an LQ
    file for every GT sub-image that does not exist."""
    root = str(tmp_path)
    _div2k_tree(root)
    jax_sub = _jax_script("extract_subimages",
                          "data_preparation/extract_subimages.py")
    for src, dst, crop, step in (("HR", "HR_sub", 48, 24),
                                 ("X4", "X4_sub", 12, 6)):
        monkeypatch.setattr(sys, "argv", [
            "extract_subimages.py", "--input", f"{root}/{src}", "--output",
            f"{root}/{dst}", "--crop_size", str(crop), "--step", str(step)])
        jax_sub.main()
    assert len(os.listdir(f"{root}/HR_sub")) == 12
    assert sorted(os.listdir(f"{root}/X4_sub"))[0] == "0001x4_s001.png"
    ds = jax_datasets.PairedImageDataset(dict(
        phase="val", scale=4, dataroot_gt=f"{root}/HR_sub",
        dataroot_lq=f"{root}/X4_sub", filename_tmpl="{}",
        io_backend={"type": "disk"}))
    assert len(ds.paths) == 12
    assert not any(osp.exists(lq) for lq, _ in ds.paths)
    with pytest.raises(Exception):
        ds[0]


# ------------------------------------------------ prepare_hifacegan_dataset

@pytest.mark.parametrize("deg_type", sorted(thiface.TEMPLATES))
def test_hifacegan_templates_match_jax(deg_type, tmp_path):
    """Two 64² faces through each template under seed 3: bit-equal to JAX's
    script, uint8, 512² after the resampling templates, the input's shape
    otherwise; `prepare` writes both under their names."""
    jax_prep = _jax_script("prepare_hifacegan_dataset",
                           "data_preparation/prepare_hifacegan_dataset.py")
    imgs = [_photo(64, 64, 1520 + i) for i in range(2)]
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    for img in imgs:
        got = thiface.degrade(img.copy(), deg_type, rngs[0])
        want = img.copy()
        for fn in jax_prep.TEMPLATES[deg_type]:
            want = fn(want, rngs[1])
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint8
        big = deg_type in ("sr4x", "sr4x8x", "full")
        assert got.shape == ((512, 512, 3) if big else img.shape)
    for i, img in enumerate(imgs):
        _write(str(tmp_path / "gt"), f"f{i}.png", img)
    assert thiface.main(["--gt_folder", str(tmp_path / "gt"),
                         "--save_folder", str(tmp_path / "lq"),
                         "--deg_type", deg_type, "--seed", "3"]) == 2
    assert sorted(os.listdir(tmp_path / "lq")) == ["f0.png", "f1.png"]


# ------------------------------------------------------- configs resolve

@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=[osp.relpath(c, osp.join(REPO, "configs"))
                              for c in CONFIGS])
def test_config_resolves_in_the_port(cfg):
    """The config parses, and every `type:` it names is the port's: the
    model, each dataset, each network (built on the meta device, which
    checks its keyword arguments), each loss (built likewise), the
    schedule and each metric."""
    from image_restoration_tpu_torch.data import datasets  # noqa: F401
    from image_restoration_tpu_torch.models import (  # noqa: F401
        distill_model, esrgan_model, gfpgan_model, hifacegan_model,
        sr_model, srgan_model, stylegan2_model)
    opt = parse(cfg, root_path=REPO, is_train="train" in osp.basename(cfg))
    MODEL_REGISTRY.get(opt["model_type"])
    for ds in (opt.get("datasets") or {}).values():
        DATASET_REGISTRY.get(ds["type"])
    train_opt = opt.get("train") or {}
    with torch.device("meta"):
        for key, net_opt in opt.items():
            if key.startswith("network_") and isinstance(net_opt, dict):
                build_network(net_opt)
        for key, sub in train_opt.items():
            if key.endswith("_opt") and isinstance(sub, dict) \
                    and "type" in sub:
                LOSS_REGISTRY.get(sub["type"])
                build_loss(sub)
    if train_opt:
        lr = float(train_opt["optim_g"].get("lr", 1e-4))
        assert build_schedule(train_opt, lr)(0) > 0
    for m in ((opt.get("val") or {}).get("metrics") or {}).values():
        METRIC_REGISTRY.get(m["type"])


def test_every_config_family_is_covered():
    """42 non-video configs, among them the zoo's 23 (EDSR 12,
    SRResNet_SRGAN 9, RCAN 2)."""
    fams = [osp.basename(osp.dirname(c)) for c in CONFIGS]
    assert len(CONFIGS) == 42
    assert (fams.count("EDSR"), fams.count("SRResNet_SRGAN"),
            fams.count("RCAN")) == (12, 9, 2)


# ----------------------------------------------- train and test pipelines

ZOO_FAMILIES = ("EDSR", "RCAN", "SRResNet_SRGAN")
ZOO_TRAIN = [c for c in CONFIGS if osp.basename(osp.dirname(c)) in
             ZOO_FAMILIES and "/train/" in c]
ZOO_TEST = [c for c in CONFIGS if osp.basename(osp.dirname(c)) in
            ZOO_FAMILIES and "/test/" in c]
# narrow widths of each arch (and of MSRGAN's D), as --force_yml entries
NARROW = {"EDSR": {"num_feat": 8, "num_block": 1},
          "MSRResNet": {"num_feat": 8, "num_block": 1},
          "RCAN": {"num_feat": 8, "num_group": 1, "num_block": 1,
                   "squeeze_factor": 4}}


def _zoo_id(cfg):
    return osp.splitext(osp.basename(cfg))[0]


@pytest.fixture(scope="module")
def div2k(tmp_path_factory):
    """A small DIV2K-style tree made by the port's scripts on the CPU: two
    288×192 photos, their MATLAB-bicubic ×2/×3/×4 LR named the DIV2K way
    (`LR/X4/0001x4.png`), the sub-image folders (HR 96/48, X2 48/24, X3
    32/16, X4 24/12; HR 144/72 with X4 36/18 for MSRGAN's 128² D) and a
    Set5-style GTmod12 / LRbicx{2,3,4} test set."""
    root = tmp_path_factory.mktemp("div2k")
    hr = root / "DIV2K_train_HR"
    for i in range(1, 3):
        _write(str(hr), f"{i:04d}.png", _photo(192, 288, 1530 + i))
    for s in (2, 3, 4):
        lr = root / "LR" / f"X{s}"
        tmat.generate_bicubic(str(hr), str(root / "Set5" / "GTmod12")
                              if s == 4 else None, str(lr), None, 12, s,
                              device="cpu")
        tmat.generate_bicubic(str(hr), None,
                              str(root / "Set5" / f"LRbicx{s}"), None, 12, s,
                              device="cpu")
        for f in os.listdir(lr):
            os.rename(lr / f, lr / f.replace(".png", f"x{s}.png"))
        tsub.extract_subimages(str(lr), str(root / f"X{s}_sub"), 96 // s,
                               48 // s, 0, 2)
    tsub.extract_subimages(str(hr), str(root / "HR_sub"), 96, 48, 0, 2)
    tsub.extract_subimages(str(hr), str(root / "HR_sub144"), 144, 72, 0, 2)
    tsub.extract_subimages(str(root / "LR" / "X4"), str(root / "X4_sub144"),
                           36, 18, 0, 2)
    return root


def _narrow(opt):
    """--force_yml entries that narrow the config's networks."""
    out = [f"network_g:{k}={v}"
           for k, v in NARROW[opt["network_g"]["type"]].items()]
    if "network_d" in opt:
        out.append("network_d:num_feat=8")
    return out


def _train_argv(div2k, cfg, extra=()):
    """train_pipeline's argv for a zoo config on the made sets: its
    dataroots, no pretrained G, narrow, batch 2, 2 steps (gt 48; 128 for
    MSRGAN's VGGStyleDiscriminator128)."""
    opt = parse(cfg, root_path=REPO)
    s = opt["scale"]
    gan = "network_d" in opt
    return ["-opt", cfg, "--force_yml",
            f"datasets:train:dataroot_gt={div2k}/HR_sub{'144' if gan else ''}",
            f"datasets:train:dataroot_lq={div2k}/X{s}_sub"
            f"{'144' if gan else ''}",
            f"datasets:train:gt_size={128 if gan else 48}",
            f"datasets:val:dataroot_gt={div2k}/Set5/GTmod12",
            f"datasets:val:dataroot_lq={div2k}/Set5/LRbicx{s}",
            "path:pretrain_network_g=~", "datasets:train:batch_size_per_gpu=2",
            "train:total_iter=2", "logger:use_tb_logger=false",
            "logger:print_freq=1", *_narrow(opt), *extra]


@pytest.mark.parametrize("cfg", ZOO_TRAIN, ids=_zoo_id)
def test_zoo_train_config_runs(div2k, tmp_path, cfg):
    """Every EDSR, RCAN and SRResNet_SRGAN train file as written but for
    its dataroots (the made sub-images and Set5), `pretrain_network_g` and
    narrow widths (RCAN ×2 also `upscale: 2`, as JAX's zoo test aligns it):
    2 steps through `train_pipeline`, every loss finite, a validation PSNR,
    and `net_g_2.pth` in the reference layout."""
    rcan_x2 = _zoo_id(cfg) == "train_RCAN_x2"
    model = train_pipeline(str(tmp_path), argv=_train_argv(
        div2k, cfg, ["network_g:upscale=2"] if rcan_x2 else ()),
        device="cpu")
    assert model.iter == 2
    assert model.log_dict and all(np.isfinite(v)
                                  for v in model.log_dict.values())
    val = model.validation(_val_loader(model), 2)
    assert np.isfinite(val["psnr"])
    ckpt = osp.join(model.opt["path"]["models"], "net_g_2.pth")
    sd = torch.load(ckpt, weights_only=True)["params"]
    head = "upconv1.weight" if model.opt["network_g"]["type"] == \
        "MSRResNet" else "upsample.0.weight"
    assert head in sd and "conv_first.weight" in sd


def _val_loader(model):
    from image_restoration_tpu_torch.data import build_dataloader
    opt = dict(model.opt["datasets"]["val"])
    return build_dataloader(build_dataset(opt), opt)


def test_rcan_x2_as_written_fails_at_its_first_loss(div2k, tmp_path):
    """train_RCAN_x2.yml puts `upscale: 4` beside `scale: 2`: as written,
    its first L1 meets a ×4 output and a ×2 GT and fails, as under JAX."""
    with pytest.raises(RuntimeError, match="size of tensor"):
        train_pipeline(str(tmp_path), argv=_train_argv(div2k, RCAN_X2),
                       device="cpu")


@pytest.mark.parametrize("cfg", ZOO_TEST, ids=_zoo_id)
def test_zoo_test_config_runs(div2k, tmp_path, cfg):
    """Every EDSR, RCAN and SRResNet_SRGAN test file as written but for
    its sets (each pointed at the made Set5; a `'{}x{s}'` set at the
    DIV2K-named LR) and `pretrain_network_g` (a narrow BasicSR-layout
    `.pth` of its arch): a finite PSNR (and SSIM where the file scores it),
    equal over the sets (they hold
    the same images), `{}` for an LQ-only set, the images written."""
    opt = parse(cfg, root_path=str(tmp_path), is_train=False)
    s = opt["scale"]
    net_opt = dict(opt["network_g"], **NARROW[opt["network_g"]["type"]])
    pth = str(tmp_path / "net_g.pth")
    torch.save({"params": build_network(
        net_opt, torch.Generator().manual_seed(1540)).state_dict()}, pth)
    sets = []
    for key, ds in opt["datasets"].items():
        tmpl = ds.get("filename_tmpl", "{}")
        lq = f"{div2k}/LR/X{s}" if tmpl != "{}" else \
            f"{div2k}/Set5/LRbicx{s}"
        sets.append(f"datasets:{key}:dataroot_lq={lq}")
        if ds["type"] == "PairedImageDataset":
            sets.append(f"datasets:{key}:dataroot_gt={div2k}/Set5/GTmod12")
    res = port_test_pipeline(str(tmp_path), argv=[
        "-opt", cfg, "--force_yml", *sets, f"path:pretrain_network_g={pth}",
        *_narrow(opt)], device="cpu")
    names = [ds["name"] for ds in opt["datasets"].values()]
    assert sorted(res) == sorted(names)
    if "woGT" in cfg:
        assert all(m == {} for m in res.values())
    else:
        first = res[names[0]]
        assert np.isfinite(first["psnr"])
        assert -1 <= first.get("ssim", 0) <= 1
        assert all(m == first for m in res.values())
    vis = tmp_path / "results" / opt["name"] / "visualization"
    assert len(os.listdir(vis)) >= 2
