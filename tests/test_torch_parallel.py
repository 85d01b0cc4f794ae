"""Multi-device training and serving of the port on the CPU: one gloo world
of two processes against the one-process step on the global batch.

The module starts one world of 2 (this file run as a script, one process
a rank) that trains one step of each of three trainers on its half of a
global batch and writes what it got; the tests read those results and
hold them against the same step run here in one process on the whole
batch:

  * the SR L1 step (`SRModel`, a narrow SRVGG ×2, paired batch);
  * the GFPGAN GAN step with its R1 step (JAX's dry-run config: the FFHQ
    degradation drawn for the global batch and cut to each rank's rows,
    the D's minibatch stddev over the global batch);
  * a StyleGAN2 step with R1 and the path-length step (32², style mixing:
    the codes and the path noise drawn for the global batch, the running
    path length from the global batch's mean);
  * the detector step (`DetectorTrainer(data_parallel=2)`, RetinaFace's
    train-mode BatchNorm over the world), in float64: its stem convolves
    [0, 255] scenes and float32 alone puts the one-process stem gradient
    5.7e-3 of max|grad| from float64, so only float64 can hold 1e-5;
  * the VGG-style D's flax BatchNorm in train mode;
  * `spatial_sharded_apply` against the direct forward.

Bounds: losses (the world's means) ≤1e-5 relative; gradients (averaged
over the world) ≤1e-5 of max|grad| of their net; parameters after the
update within JAX's own DP bound of 5e-3 (`tests/test_detect.py:160`:
Adam's first step turns a gradient's sign into ±lr), and equal on both
ranks; BatchNorm statistics ≤1e-6 of their largest; the spatial interior equal to the
direct forward (JAX's `tests/test_spatial.py` claim). Serving over
["cpu", "cpu"] (`Restorer(data_parallel=2)`, `tiled_apply(mesh=...)`) is
bit-equal to one device, and `dryrun_multichip(2)` passes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from image_restoration_tpu_torch.archs import build_network  # noqa: E402
from image_restoration_tpu_torch.models import build_model  # noqa: E402
from image_restoration_tpu_torch.parallel.dryrun import (  # noqa: E402
    free_port, gan_degradation, gan_options)

WORLD = 2
SR_OPT = {
    "is_train": True, "manual_seed": 0, "model_type": "SRModel",
    "network_g": dict(type="SRVGGNetCompact", num_feat=8, num_conv=2,
                      upscale=2),
    "train": {"optim_g": {"type": "Adam", "lr": 1e-3},
              "scheduler": {"type": "MultiStepLR", "milestones": [100],
                            "gamma": 0.5},
              "total_iter": 2,
              "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}},
}
VGG_D = dict(type="VGGStyleDiscriminator128", num_in_ch=3, num_feat=8)
SG2_OPT = {
    "is_train": True, "manual_seed": 0, "model_type": "StyleGAN2Model",
    "network_g": dict(type="StyleGAN2Generator", out_size=32,
                      num_style_feat=16, num_mlp=2, channel_multiplier=0.25,
                      narrow=0.125),
    "network_d": dict(type="StyleGAN2Discriminator", out_size=32,
                      channel_multiplier=0.25, narrow=0.125),
    "train": {"optim_g": {"type": "Adam", "lr": 0.002},
              "optim_d": {"type": "Adam", "lr": 0.002},
              "scheduler": {"type": "MultiStepLR", "milestones": [100],
                            "gamma": 0.5},
              "total_iter": 2,
              "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus",
                          "loss_weight": 1.0},
              "r1_reg_weight": 10, "path_batch_shrink": 2,
              "path_reg_weight": 2, "net_g_reg_every": 1,
              "net_d_reg_every": 1, "mixing_prob": 0.9},
}


def _sr_batch():
    rng = np.random.default_rng(5)
    return {"lq": rng.random((4, 8, 8, 3), np.float32),
            "gt": rng.random((4, 16, 16, 3), np.float32)}


def _gan_gt():
    return np.random.default_rng(0).random((4, 32, 32, 3), np.float32)


def _det_batch():
    from image_restoration_tpu_torch.detect.synth import make_batch
    return make_batch(torch.Generator().manual_seed(2), 4, 64)


def _vgg_x():
    return torch.from_numpy(np.random.default_rng(4).random(
        (4, 128, 128, 3), np.float32))


def _state(model_nets):
    """{name: {"grad": …, "param": …}} of the listed nets' parameters."""
    out = {}
    for tag, net in model_nets.items():
        for k, p in net.named_parameters():
            out[f"{tag}.{k}"] = {
                "grad": None if p.grad is None else p.grad.detach().clone(),
                "param": p.detach().clone()}
    return out


def run_steps(root, rows=slice(None)):
    """Each trainer's step on `rows` of its global batch (all of it in one
    process, a rank's half in the world); what the tests compare."""
    from image_restoration_tpu_torch.detect.train import DetectorTrainer
    from image_restoration_tpu_torch.parallel.spatial import \
        spatial_sharded_apply
    from image_restoration_tpu_torch.utils.dist_util import (
        get_dist_info, reduce_loss_dict)
    world = get_dist_info()[1]
    res = {}

    opt = dict(SR_OPT, num_devices=world,
               path={"models": os.path.join(root, "sr")})
    sr = build_model(opt, device="cpu")
    batch = {k: v[rows] for k, v in _sr_batch().items()}
    sr.optimize_parameters(1, batch)
    res["sr"] = {"losses": sr.log_dict, "nets": _state({"g": sr.net_g})}

    gan = build_model(gan_options(world, os.path.join(root, "gan")),
                      device="cpu")
    gan.set_degradation_pipeline(gan_degradation())
    gan.optimize_parameters(1, {"gt": _gan_gt()[rows]})
    res["gan"] = {"losses": gan.log_dict,
                  "nets": _state({"g": gan.net_g, "d": gan.net_d})}

    sg2 = build_model(dict(SG2_OPT, num_devices=world,
                           path={"models": os.path.join(root, "sg2")}),
                      device="cpu")
    sg2.optimize_parameters(1, {"gt": _gan_gt()[rows] * 2 - 1})
    res["sg2"] = {"losses": sg2.log_dict,
                  "nets": _state({"g": sg2.net_g, "d": sg2.net_d})}

    det = DetectorTrainer(backbone="mobilenet0.25", image_size=64, lr=1e-3,
                          data_parallel=world if world > 1 else 0,
                          device="cpu")
    det.net.double()  # float64: see the module docstring
    det.priors = det.priors.double()
    imgs, targets = _det_batch()
    losses = det.train_step(imgs, targets)  # the global batch
    stats = {k: v.clone() for k, v in det.net.state_dict().items()
             if "running" in k}
    res["det"] = {"losses": reduce_loss_dict(losses),
                  "nets": _state({"net": det.net}), "stats": stats}

    d = build_network(VGG_D, torch.Generator().manual_seed(3)).train()
    with torch.no_grad():
        y = d(_vgg_x()[rows], refresh_stats=True)
    res["bn"] = {"y": y, "stats": {k: v.clone() for k, v in
                                   d.state_dict().items() if "running" in k}}

    net = build_network(dict(type="SRVGGNetCompact", num_feat=8, num_conv=2,
                             upscale=4), torch.Generator().manual_seed(1))
    img = torch.from_numpy(np.random.default_rng(1).random(
        (1, 16, 12, 3), np.float32))
    with torch.no_grad():
        res["spatial"] = {"sharded": spatial_sharded_apply(net, img, halo=5,
                                                           scale=4),
                          "full": net(img)}
    return res


def _worker(rank, port, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        rows = slice(rank * 2, rank * 2 + 2)
        torch.save(run_steps(out, rows), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the world's results per rank, the one-process results)."""
    out = str(tmp_path_factory.mktemp("world2"))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), str(port), out], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_steps(str(tmp_path_factory.mktemp("one")))
    finally:
        torch.set_num_threads(n)
    return ranks, one


def _rel_losses(got, want):
    assert got.keys() == want.keys()
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
               for k in want)


@pytest.mark.parametrize("part", ["sr", "gan", "sg2", "det"])
def test_world_step_equals_global_batch_step(worlds, part):
    ranks, one = worlds
    for r in ranks:
        assert _rel_losses(r[part]["losses"], one[part]["losses"]) <= 1e-5
    nets = one[part]["nets"]
    for tag in {k.split(".")[0] for k in nets}:
        keys = [k for k in nets if k.split(".")[0] == tag]
        gmax = max(float(nets[k]["grad"].abs().max()) for k in keys
                   if nets[k]["grad"] is not None)
        for k in keys:
            want = nets[k]
            got = [r[part]["nets"][k] for r in ranks]
            if want["grad"] is not None:
                err = float((got[0]["grad"] - want["grad"]).abs().max())
                assert err <= 1e-5 * gmax, (k, err, gmax)
            assert float((got[0]["param"] - want["param"]).abs().max()) \
                <= 5e-3, k
            torch.testing.assert_close(got[1]["param"], got[0]["param"],
                                       rtol=0, atol=0)


def test_world_batchnorm_statistics(worlds):
    ranks, one = worlds
    for part in ("det", "bn"):
        for k, want in one[part]["stats"].items():
            for r in ranks:
                err = float((r[part]["stats"][k] - want).abs().max())
                assert err <= 1e-6 * float(want.abs().max()), (k, err)
    y = torch.cat([r["bn"]["y"] for r in ranks])
    assert float((y - one["bn"]["y"]).abs().max()) <= \
        1e-5 * float(one["bn"]["y"].abs().max())


def test_spatial_sharded_interior_equals_direct(worlds):
    ranks, one = worlds
    full = one["spatial"]["full"]
    inner = slice(4 * 5, -4 * 5)
    for r in ranks + [one]:  # a world of one too
        sharded = r["spatial"]["sharded"]
        assert sharded.shape == full.shape
        torch.testing.assert_close(sharded[:, inner], full[:, inner],
                                   rtol=0, atol=1e-6)


def test_serving_over_two_devices_is_bit_equal():
    from image_restoration_tpu_torch.infer import SR_MEAN_STD, Restorer
    from image_restoration_tpu_torch.parallel.mesh import make_mesh
    from image_restoration_tpu_torch.parallel.tiling import tiled_apply
    opt = dict(type="SRVGGNetCompact", num_feat=8, num_conv=2, upscale=2)
    one = Restorer(opt, device="cpu", **SR_MEAN_STD)
    two = Restorer(opt, data_parallel=2, devices=["cpu", "cpu"],
                   **SR_MEAN_STD)
    u8 = (np.random.default_rng(0).random((5, 12, 12, 3)) * 255
          ).astype(np.uint8)  # 5: padded to 6, cut back
    np.testing.assert_array_equal(two.restore_batch_u8(u8),
                                  one.restore_batch_u8(u8))
    np.testing.assert_array_equal(two.restore_batch(u8 / 255.0),
                                  one.restore_batch(u8 / 255.0))
    img = u8[0].repeat(3, 0).repeat(2, 1)  # 36 × 24
    for fn in ("restore_tiled_u8", "restore_tiled"):
        a = getattr(two, fn)(img if fn.endswith("u8") else img / 255.0,
                             tile=8, halo=2, scale=2, tile_batch=3)
        b = getattr(one, fn)(img if fn.endswith("u8") else img / 255.0,
                             tile=8, halo=2, scale=2, tile_batch=3)
        np.testing.assert_array_equal(a, b)
    x = torch.from_numpy(np.random.default_rng(1).random((1, 20, 28, 3),
                                                         np.float32))
    mesh = make_mesh(["cpu", "cpu"])
    order = []

    def fn(t):
        order.append(t.shape[0])
        return t * 2.0

    got = tiled_apply(fn, x, tile=8, halo=2, tile_batch=3, mesh=mesh)
    want = tiled_apply(lambda t: t * 2.0, x, tile=8, halo=2, tile_batch=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(order) == {2}  # tile_batch 3 → 4, two tiles a device
    mesh.close()


def test_without_a_matching_world_it_raises(tmp_path, monkeypatch):
    from image_restoration_tpu_torch.detect.train import DetectorTrainer
    from image_restoration_tpu_torch.infer import Restorer
    from image_restoration_tpu_torch.utils.dist_util import (get_dist_info,
                                                             init_dist)
    assert get_dist_info() == (0, 1)
    with pytest.raises(RuntimeError, match="torchrun"):
        build_model(dict(SR_OPT, num_devices=2,
                         path={"models": str(tmp_path)}), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        DetectorTrainer(backbone="mobilenet0.25", image_size=64,
                        data_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="local devices"):
        Restorer(dict(type="SRVGGNetCompact", num_feat=8, num_conv=2,
                      upscale=2),
                 data_parallel=max(2, torch.cuda.device_count() + 1))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_dist("gloo")


def test_dryrun_multichip_two():
    from image_restoration_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
