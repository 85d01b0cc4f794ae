"""The training-evidence scripts of the port against the repo-root JAX
scripts they come from (`scripts/bench_train.py --convergence`,
`bench_gan_ablation.py`, `bench_qat_distill.py`, `bench_distill_e2e.py`,
`bench_gfpgan_longrun.py`), on the CPU at tiny sizes:

* each port builder's options and degradation config equal what JAX's
  builder passes to `build_model` at the same arguments (captured by
  monkeypatching, so no JAX net is built);
* the metric helpers agree with JAX's on the same seeded inputs;
* arms start bit-equal and see bit-equal LQ batches;
* the long run's lr and pyramid weight, step by step, follow JAX's
  schedule;
* a `--tiny` run of each script: finite losses, and the report's top-level
  keys those of JAX's record in `docs/assets/`;
* with no photos the GT crops are seeded synthetic plate scenes (JAX's
  fallback is uniform noise, which no restorer can learn).
"""

import copy
import dataclasses
import importlib
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from image_restoration_tpu_torch.data.pipelines import (
    FFHQDegradationConfig, RealESRGANDegradationConfig)
from image_restoration_tpu_torch.scripts import (distill_e2e, gan_ablation,
                                                 gfpgan_longrun, qat_distill,
                                                 train_convergence as tc)

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "docs" / "assets"
BF16 = "bf16"   # a case's dtype: jnp.bfloat16 for JAX, torch.bfloat16 here


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_scripts():
    """The JAX scripts as modules (they import `bench` and `bench_train`
    from the repo root and `scripts/`)."""
    added = [str(REPO), str(REPO / "scripts")]
    sys.path[:0] = added
    try:
        return types.SimpleNamespace(**{
            name: importlib.import_module(name) for name in (
                "bench_train", "bench_gan_ablation", "bench_qat_distill",
                "bench_distill_e2e")})
    finally:
        for p in added:
            sys.path.remove(p)


class _Built(Exception):
    """Raised by the fake model once JAX's builder has handed it all."""


def _capture(monkeypatch, fn, *args, **kwargs):
    """(options, degradation config) that JAX's `fn` passes to
    `build_model` and the degradation maker."""
    import image_restoration_tpu.data.pipelines as jp
    import image_restoration_tpu.models as jm
    got = {}

    def build_model(opt):
        got["opt"] = copy.deepcopy(opt)

        def set_degradation_pipeline(cfg):
            got["cfg"] = cfg
            raise _Built
        return types.SimpleNamespace(
            set_degradation_pipeline=set_degradation_pipeline)

    monkeypatch.setattr(jm, "build_model", build_model)
    monkeypatch.setattr(jp, "make_ffhq_degradation", lambda cfg: cfg)
    monkeypatch.setattr(jp, "make_realesrgan_degradation", lambda cfg: cfg)
    with pytest.raises(_Built):
        fn(*args, **kwargs)
    return got["opt"], got["cfg"]


def _norm(x):
    """Options without their `path` (a directory of the run), dtypes by
    name, lists and tuples alike."""
    import jax.numpy as jnp
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k != "path"}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if x is jnp.bfloat16 or x is torch.bfloat16:
        return "bf16"
    return x


def _sides(case):
    import jax.numpy as jnp
    jax_kw = {k: (jnp.bfloat16 if v == BF16 else v) for k, v in case.items()}
    port_kw = {k: (torch.bfloat16 if v == BF16 else v)
               for k, v in case.items()}
    return jax_kw, port_kw


def _longrun_case(scale):
    """JAX's long-run builder arguments at `--recipe-scale scale`
    (`scripts/bench_gfpgan_longrun.py` main)."""
    return dict(batch=8, dtype=BF16, img_hw=256, total_iter=20000,
                milestones=(100000 // scale, 150000 // scale),
                remove_pyramid_loss=50000 // scale, grad_clip=1.0)


GFPGAN_CASES = {
    "convergence_f32": dict(batch=8),
    "convergence_bf16": dict(batch=8, dtype=BF16),
    "ablation_l1": dict(batch=8, perceptual=False, gan_weight=0.0),
    "ablation_tiny": dict(batch=2, img_hw=32, tiny_net=True),
    "grad_clip_remat": dict(batch=4, grad_clip=0.5, remat=True),
    **{f"longrun_scale_{s}": _longrun_case(s) for s in (1, 10, 100, 2000)},
}


@pytest.mark.parametrize("name", sorted(GFPGAN_CASES))
def test_gfpgan_builder_matches_jax(jax_scripts, monkeypatch, name):
    jax_kw, port_kw = _sides(GFPGAN_CASES[name])
    jopt, jcfg = _capture(monkeypatch,
                          jax_scripts.bench_train.build_gfpgan_trainer,
                          **jax_kw)
    opt, deg = tc.gfpgan_trainer_options(**port_kw)
    assert _norm(opt) == _norm(jopt)
    assert _norm(dataclasses.asdict(FFHQDegradationConfig(**deg))) == \
        _norm(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("scale", [1, 10, 100, 2000])
def test_longrun_recipe_matches_jax(scale):
    case = _longrun_case(scale)
    assert gfpgan_longrun.recipe(scale) == (case["milestones"],
                                            case["remove_pyramid_loss"])


SR_CASES = {
    "convergence": dict(batch=8),
    "qat_w8": dict(batch=8, quant=True, lr=1e-3),
    "qat_w4": dict(batch=8, quant=True, lr=1e-3, weight_bits=4),
    "qat_w2": dict(batch=8, quant=True, lr=1e-3, weight_bits=2),
    "tiny": dict(batch=2, gt_hw=64, num_feat=8, num_conv=2),
}


@pytest.mark.parametrize("name", sorted(SR_CASES))
def test_sr_builder_matches_jax(jax_scripts, monkeypatch, name):
    jax_kw, port_kw = _sides(SR_CASES[name])
    jopt, jcfg = _capture(monkeypatch, jax_scripts.bench_train.build_sr_trainer,
                          **jax_kw)
    opt, deg = tc.sr_trainer_options(**port_kw)
    assert _norm(opt) == _norm(jopt)
    assert _norm(dataclasses.asdict(RealESRGANDegradationConfig(**deg))) == \
        _norm(dataclasses.asdict(jcfg))


DISTILL_CASES = {
    "teacher_23": ("teacher", (8, 23, 256)),
    "teacher_tiny": ("teacher", (2, 1, 64)),
    "student_l1": ("student", (8, 64, 32, 256)),
    "student_distill": ("student", (8, 64, 32, 256, 4, 1e-3, 23)),
    "student_tiny": ("student", (2, 8, 2, 64, 4, 1e-3, 1)),
}


@pytest.mark.parametrize("name", sorted(DISTILL_CASES))
def test_distill_builders_match_jax(jax_scripts, monkeypatch, name):
    kind, args = DISTILL_CASES[name]
    jmod = jax_scripts.bench_distill_e2e
    if kind == "teacher":
        jopt, _ = _capture(monkeypatch, jmod.build_teacher_trainer, *args)
        opt = distill_e2e.teacher_options(*args[1:])
    else:
        jopt, _ = _capture(monkeypatch, jmod.build_student_trainer, *args)
        opt = distill_e2e.student_options(*args[1:])
    assert _norm(opt) == _norm(jopt)


@pytest.mark.parametrize("blocks", [23, 1])
def test_distill_step_options_match_jax(jax_scripts, monkeypatch, blocks):
    jopt, _ = _capture(monkeypatch,
                       jax_scripts.bench_qat_distill.bench_distill_step,
                       batch_sizes=(8,), teacher_blocks=blocks)
    assert _norm(qat_distill.distill_options(64, 32, blocks, 256, 4)) == \
        _norm(jopt)


# ---------------------------------------------------------------- helpers

def _images(seed, n=4, hw=96):
    """Seeded smooth RGB uint8 images (an upsampled coarse grid plus
    grain), so gradients and NIQE have structure to see."""
    import cv2
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coarse = rng.random((6, 6, 3)).astype(np.float32) * 255
        img = cv2.resize(coarse, (hw, hw), interpolation=cv2.INTER_CUBIC)
        img = img + rng.normal(0, 6, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def test_metric_helpers_match_jax(jax_scripts):
    jab = jax_scripts.bench_gan_ablation
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.3, 1.3, (2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(gan_ablation.to_u8_rgb(x), jab.to_u8_rgb(x))
    a, b = _images(1), _images(2)
    for got, want in ((gan_ablation.gradient_similarity(a, b),
                       jab.gradient_similarity(a, b)),
                      (gan_ablation.montage_niqe(a), jab.montage_niqe(a))):
        assert got == pytest.approx(want, rel=1e-6)
    ref = rng.random((2, 8, 8, 3))
    got = ref + rng.normal(0, 0.05, ref.shape)
    assert qat_distill._span_psnr(ref, got) == pytest.approx(
        jax_scripts.bench_qat_distill._span_psnr(ref, got), rel=1e-6)
    # a montage with no 96² block has no NIQE; JAX's run catches the raise
    assert gan_ablation.niqe_or_none(a[:2, :64, :64]) is None


# ------------------------------------------------------------ same start

def _state(net):
    return [t.clone() for t in net.state_dict().values()]


def test_sr_arms_start_bit_equal_on_one_stream():
    """The PTQ/QAT arms and the two student arms: one init, and the same
    LQ batches from generators seeded alike."""
    pool = tc.device_pool(tc.real_crops(64, 4, np.random.default_rng(0)),
                          "cpu")
    small = dict(num_feat=8, num_conv=2, device="cpu")
    pairs = [(tc.build_sr_trainer(2, gt_hw=64, **small),
              tc.build_sr_trainer(2, gt_hw=64, quant=True, lr=1e-3,
                                  **small)),
             (distill_e2e.build_student_trainer(2, 8, 2, 64, device="cpu"),
              distill_e2e.build_student_trainer(2, 8, 2, 64, teacher_block=1,
                                                device="cpu"))]
    for a, b in pairs:
        assert all(torch.equal(x, y) for x, y in zip(_state(a.net_g),
                                                     _state(b.net_g)))
        seen = {}
        for name, model in (("a", a), ("b", b)):
            seen[name] = []
            gan_ablation._probe_lq(model, seen[name])
            gen = torch.Generator().manual_seed(2)
            tc.train_chunk(model, pool, 2, 1, gen, ("l_pix",))
        assert len(seen["a"]) == 1
        assert all(torch.equal(x, y) for x, y in zip(seen["a"], seen["b"]))


# -------------------------------------------------------------- schedule

def test_longrun_schedule_matches_jax_every_iteration():
    """`schedule_at` against JAX's MultiStepLR (its lr_scheduler, at the
    options JAX's builder writes) and its pyramid rule
    (`models/gfpgan_model.py`: the weight while iter < remove_pyramid_loss,
    then 1e-12) at every iteration of the 100-iteration recipe and around
    each crossing of the others."""
    from image_restoration_tpu.models.lr_scheduler import build_schedule
    for scale in (1, 10, 100, 2000):
        milestones, remove = gfpgan_longrun.recipe(scale)
        opt, _ = tc.gfpgan_trainer_options(
            8, milestones=milestones, remove_pyramid_loss=remove)
        train = opt["train"]
        jsched = build_schedule(train, 2e-3)
        its = (range(200000 // scale) if scale == 2000 else
               sorted({c + d for c in (0, *milestones, remove)
                       for d in (-1, 0, 1) if c + d >= 0}))
        for it in its:
            lr, pyr = gfpgan_longrun.schedule_at(it, milestones, remove)
            assert lr == pytest.approx(float(jsched(it)), rel=1e-6), it
            want = (train["pyramid_loss_weight"]
                    if it < train["remove_pyramid_loss"] else 1e-12)
            assert pyr == want, it


class _CountingModel:
    """A stand-in trainer: each step returns the next of `losses`."""

    def __init__(self, losses):
        self.iter, self.losses, self.batches = 0, list(losses), []

    def optimize_parameters(self, it, data, generator):
        assert it == self.iter
        self.batches.append(data["gt"][:, 0].tolist())
        self.iter += 1
        return {"l_pix": torch.tensor(self.losses[it])}


def test_train_loop_chunks_checks_and_budget():
    """The loop every script shares: chunks from `done` to the total, the
    batch rotating through the pool from its start each chunk, the chunk's
    losses handed to the callback; a non-finite loss fails the run; a wall
    budget stops before a chunk that would cross it (never before the
    first)."""
    pool = torch.arange(5.0)[:, None]
    seen = []
    model = _CountingModel([0.5] * 6)
    done = tc.train_loop(model, pool, 2, 6, 3, None, ("l_pix",), "t",
                         lambda d, losses, dt: seen.append(
                             (d, losses["l_pix"].tolist())))
    assert done == 6 and model.iter == 6
    assert seen == [(3, [0.5] * 3), (6, [0.5] * 3)]
    assert model.batches == [[0, 1], [2, 3], [3, 4]] * 2
    model = _CountingModel([0.5, float("nan"), 0.5])
    with pytest.raises(FloatingPointError, match="non-finite"):
        tc.train_loop(model, pool, 1, 3, 3, None, ("l_pix",), "t")
    model = _CountingModel([0.5] * 8)
    model.iter = 2
    assert tc.train_loop(model, pool, 1, 8, 2, None, ("l_pix",), "t",
                         budget_s=0.0, done=2) == 4


# ------------------------------------------------------------ tiny runs

def _jax_keys(name):
    with open(ASSETS / name) as f:
        return set(json.load(f))


def _finite(curve, *keys):
    return all(v is None or np.isfinite(v) for k in keys for v in curve[k])


@pytest.mark.parametrize("kind", ["sr", "gfpgan"])
def test_train_convergence_tiny(tmp_path, kind):
    out = tmp_path / "r.json"
    report = tc.main(["--tiny", "--conv-model", kind, "--conv-iters", "1",
                      "--conv-bs", "1", "--out", str(out)])
    assert set(report) == _jax_keys(f"train_convergence_{kind}.json")
    assert json.loads(out.read_text())["curve"]["iters"] == [0, 1]
    assert _finite(report["curve"], "loss", "val_psnr", "val_psnr_live")


def test_gan_ablation_tiny(tmp_path):
    """Both arms from one init on one stream: bit-equal at the start and in
    their LQ batches (the tiny run's two)."""
    det = torch.backends.cudnn.deterministic
    out, ev = gan_ablation.main(["--tiny", "--out",
                                 str(tmp_path / "r.json")])
    assert torch.backends.cudnn.deterministic == det
    assert set(out) == _jax_keys("gan_ablation.json")
    assert ev["init_bit_equal"] and ev["lq_bit_equal"]
    assert ev["lq_batches_compared"] == 2
    for arm in ("gan", "l1"):
        assert _finite(out[f"{arm}_curve"], "l_pix", "l_d",
                       "val_psnr_ema", "val_psnr_live")
        assert os.path.isfile(ev["triptychs"][arm])


def test_qat_distill_tiny(tmp_path):
    out = qat_distill.main(["--tiny", "--out", str(tmp_path / "r.json")])
    assert set(out) == _jax_keys("qat_distill_bench.json")
    for sec in ("qat_vs_ptq", "qat4_vs_ptq4", "qat2_vs_ptq2"):
        assert all(np.isfinite(v) for k, v in out[sec].items()
                   if k.endswith("psnr"))
    # on the CPU the engine runs K2's plain version: no launch counted
    assert out["qat_vs_ptq"]["k2_launches_per_engine_call"] == [0, 0]


def test_distill_e2e_tiny(tmp_path):
    """JAX's record comes from a run that restored its teacher, so it has
    no `teacher_curve`; a run that trains one writes it (as JAX's
    `train_loop` does)."""
    out, ev = distill_e2e.main(["--tiny", "--out", str(tmp_path / "r.json")])
    assert set(out) - {"teacher_curve"} == _jax_keys("distill_e2e.json")
    assert out["complete"] and "teacher_curve" in out
    for arm in ("l1", "distill"):
        assert _finite(out[f"student_{arm}_curve"], "loss", "val_psnr_ema")
    assert len(out["budget_points"]) == 1


def test_gfpgan_longrun_tiny_crosses_the_schedule(tmp_path):
    """A tiny run at a recipe scale whose milestones (2, 3) and pyramid
    removal (1) fall inside its 4 iterations: the lr and the pyramid weight
    each step used equal JAX's schedule, and the engine round-trips."""
    scale = 50000
    out, ev = gfpgan_longrun.run(
        iters=4, recipe_scale=scale, bs=1, chunk=4, val_every=4,
        niqe_every=4, snapshot_iter=2, budget_s=1e9, tiny=True,
        device="cpu", exp_dir=str(tmp_path))
    assert set(out) == _jax_keys("gfpgan_longrun.json")
    assert out["complete"] and out["iters_done"] == 4
    assert _finite(out["curve"], "l_pix", "l_d", "l_gan", "val_psnr_ema")
    milestones, remove = gfpgan_longrun.recipe(scale)
    assert (milestones, remove) == ((2, 3), 1)
    assert ev["iters"] == [0, 1, 2, 3]
    for it, lr, pyr in zip(ev["iters"], ev["lr_g"], ev["pyr_w"]):
        assert (lr, pyr) == pytest.approx(
            gfpgan_longrun.schedule_at(it, milestones, remove), rel=1e-9)
    assert ev["engine_db"] >= 60.0


# ------------------------------------------------------------------ data

def test_no_photos_means_seeded_synthetic_plates(tmp_path):
    """The data departure: with no photos the crops are
    `detect/synth.py` plate scenes drawn from the numpy generator (the
    same for the same seed, RGB in [0, 1], a bright plate with dark
    strokes: far from JAX's uniform noise); with a folder of photos the
    crops come from the photos."""
    import cv2
    a = tc.real_crops(64, 3, np.random.default_rng(5))
    b = tc.real_crops(64, 3, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 64, 64, 3) and a.dtype == np.float32
    assert 0.0 <= a.min() and a.max() <= 1.0
    # noise has no plate: a synthetic scene has a near-uniform bright
    # region (the plate) and a dark text level
    assert (a > 0.7).mean() > 0.02 and np.abs(np.diff(a, axis=1)).mean() < \
        np.abs(np.diff(np.random.default_rng(0).random(a.shape),
                       axis=1)).mean() / 2
    photo = (np.random.default_rng(1).random((80, 90, 3)) * 255).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "p.png"), photo)
    paths = tc.photo_paths(str(tmp_path))
    crops = tc.real_crops(64, 2, np.random.default_rng(3), paths)
    ys = np.random.default_rng(3)
    y, x = ys.integers(0, 80 - 64 + 1), ys.integers(0, 90 - 64 + 1)
    np.testing.assert_allclose(
        crops[0], photo[y:y + 64, x:x + 64, ::-1] / 255.0, atol=1e-7)
