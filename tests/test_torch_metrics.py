"""The port's metrics (InceptionV3 and FID, LPIPS, NIQE, the metric CLIs)
against the JAX package on the CPU.

  * InceptionV3 against the flax net at random weights and BatchNorm
    statistics carried by `inception_state_dict_from_jax`, at 2 × 96²
    with `resize_input=False` (1e-5 of max|ref|); the port's state_dict,
    saved as a pt_inception-style `.pth`, through JAX's
    `load_patched_inception_v3(weights_path)` at 299² (1e-4 of max|ref|:
    the resize and 95 float32 layers);
  * `calculate_fid` against JAX's on random well-conditioned Gaussians at
    d = 64 and on a pair that takes the eps branch (1e-9 relative);
  * LPIPS at 64² with lin weights and with uniform ones, on the same VGG16
    (1e-5 relative); NIQE on a 192² image (1e-9 relative);
    `calculate_metric` dispatch;
  * `calculate_stylegan2_fid.sample` against the lines of JAX's script at a
    narrow 64² generator on the same codes, truncation around the mean
    latent of the same codes (1e-5 of max|ref|);
  * JAX's FID-scale fault: its statistics path hands Inception the dataset's
    [-1, 1] GT, its sample path [0, 1]; the port feeds both [0, 1];
  * each CLI with `--device cpu` on tiny folders; the folder FID, LPIPS,
    NIQE and PSNR/SSIM CLIs against the same-named scripts of
    `scripts/metrics/` on the same files and weights.
"""

import contextlib
import importlib.util
import io
import os
import sys
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_tpu.archs import build_network as jax_build_network
from image_restoration_tpu.data.datasets import FFHQDataset as JaxFFHQDataset
from image_restoration_tpu.metrics import calculate_niqe as jax_niqe
from image_restoration_tpu.metrics.fid import calculate_fid as jax_fid
from image_restoration_tpu.metrics.fid import \
    load_patched_inception_v3 as jax_load_inception
from image_restoration_tpu.metrics.lpips import LPIPS as JaxLPIPS
from image_restoration_tpu.ops.resize import resize as jax_resize
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.convert import (
    inception_state_dict_from_jax, state_dict_from_jax)
from image_restoration_tpu_torch.data import DataLoader, build_dataset
from image_restoration_tpu_torch.metrics import (calculate_lpips,
                                                 calculate_metric,
                                                 calculate_niqe,
                                                 calculate_psnr,
                                                 calculate_ssim)
from image_restoration_tpu_torch.metrics.fid import (
    calculate_fid, extract_inception_features, load_patched_inception_v3)
from image_restoration_tpu_torch.metrics.lpips import LPIPS
from image_restoration_tpu_torch.ops.resize import resize
from image_restoration_tpu_torch.scripts import (
    calculate_fid_folder, calculate_fid_stats_from_datasets,
    calculate_lpips as lpips_cli, calculate_niqe_folder,
    calculate_psnr_ssim, calculate_stylegan2_fid)
from image_restoration_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """One intra-op thread while this file runs: several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_cli(monkeypatch, name, argv):
    """JAX's `scripts/metrics/<name>.py` as a module, with `argv` set for
    its `main()`."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    return mod


def _record(monkeypatch, mod, name):
    """Wrap `mod.name` so that every value it returns is kept; returns the
    list of values."""
    fn, values = getattr(mod, name), []

    def recorded(*args, **kwargs):
        values.append(fn(*args, **kwargs))
        return values[-1]

    monkeypatch.setattr(mod, name, recorded)
    return values


def _images(folder, n, hw, seed):
    """`n` seeded smooth RGB images under `folder`, written at PNG level 1;
    returns their names."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        small = rng.integers(0, 256, (hw[0] // 4, hw[1] // 4, 3)).astype(
            np.uint8)
        img = cv2.resize(small, (hw[1], hw[0]),
                         interpolation=cv2.INTER_LINEAR)
        names.append(f"{i:05d}.png")
        cv2.imwrite(os.path.join(folder, names[-1]), img,
                    [cv2.IMWRITE_PNG_COMPRESSION, 1])
    return names


# ------------------------------------------------------------ InceptionV3


@pytest.fixture(scope="module")
def flax_inception():
    """The flax InceptionV3 (resize_input off) at seeded random params and
    BatchNorm statistics (shapes from `eval_shape`, no compiled init), its
    jitted apply, and the port's net holding the same."""
    jnet = jax_build_network(dict(type="InceptionV3", resize_input=False))
    shapes = jax.eval_shape(lambda k, x: jnet.init(k, x),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 3)))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), s.shape)
        return {"scale": lambda: rng.uniform(0.5, 1.5, s.shape),
                "bias": lambda: rng.normal(0, 0.2, s.shape),
                "mean": lambda: rng.normal(0, 0.3, s.shape),
                "var": lambda: rng.uniform(0.5, 2.0, s.shape)}[name]()

    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(fill(p, s), np.float32), shapes)
    port = build_network(dict(type="InceptionV3", resize_input=False))
    port.load_state_dict(inception_state_dict_from_jax(
        port, variables["params"], variables["batch_stats"]), strict=True)
    apply = jax.jit(lambda x: jnet.apply(variables, x, train=False))
    return jnet, variables, apply, port.eval()


def test_inception_matches_flax(flax_inception):
    """The port's InceptionV3 against flax at the same random weights and
    statistics, 2 × 96² RGB in [0, 1], resize_input off: 1e-5 of
    max|ref|."""
    jnet, _, apply, port = flax_inception
    x = np.random.default_rng(1).random((2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(apply(x))
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == (2, 2048) and float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def inception_pth(flax_inception, tmp_path_factory):
    """The port's state_dict plus an `fc` head, saved as a pt_inception
    `.pth`."""
    _, _, _, port = flax_inception
    sd = {k: v for k, v in port.state_dict().items()}
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    pth = tmp_path_factory.mktemp("inception") / "pt_inception.pth"
    torch.save(sd, str(pth))
    return str(pth)


def test_port_state_dict_loads_into_jax_load_patched(inception_pth):
    """The port's state_dict as a pt_inception `.pth` through JAX's
    `load_patched_inception_v3(weights_path)` and the port's, at 2 × 64²
    resized to 299² inside: 1e-4 of max|ref|."""
    x = np.random.default_rng(2).random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_load_inception(inception_pth)(jnp.asarray(x)))
    net = load_patched_inception_v3(inception_pth, device="cpu")
    assert net.resize_input and net.normalize_input
    got = extract_inception_features([x], net)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_fid_scale_fault_in_jax_and_one_scale_in_the_port(flax_inception,
                                                          tmp_path):
    """One image as a dataset item and as a generated sample. JAX's
    statistics path (`calculate_fid_stats_from_datasets.py:47-51`) hands
    Inception FFHQDataset's normalized GT, in [-1, 1]; its sample path
    (`calculate_stylegan2_fid.py:72`) hands it clip((img + 1)/2) in
    [0, 1]; Inception's 2x − 1 then sees [-3, 1] against [-1, 1], and the
    features differ. The port's two paths hand it the same [0, 1] image."""
    _images(tmp_path / "gt", 1, (96, 96), 3)
    opt = dict(dataroot_gt=str(tmp_path / "gt"), io_backend={"type": "disk"},
               use_hflip=False, mean=[0.5] * 3, std=[0.5] * 3)
    jnet, _, apply, _ = flax_inception
    assert jnet.normalize_input  # JAX's InceptionV3 maps x to 2x − 1
    assert jax_build_network(dict(type="InceptionV3")).normalize_input
    gt = JaxFFHQDataset(dict(opt))[0]["gt"][None]  # what JAX's stats feed
    img = gt  # the same picture as a generator's [-1, 1] output
    jax_stats_in = np.asarray(gt)
    jax_sample_in = np.asarray(jnp.clip((jnp.asarray(img) + 1) / 2, 0, 1))
    assert jax_stats_in.min() < -0.5 and jax_sample_in.min() >= 0
    seen_stats, seen_sample = 2 * jax_stats_in - 1, 2 * jax_sample_in - 1
    assert np.abs(seen_stats - seen_sample).max() > 0.5
    f_stats, f_sample = np.asarray(apply(jax_stats_in)), np.asarray(
        apply(jax_sample_in))
    assert np.abs(f_stats - f_sample).max() > 0.1 * np.abs(f_sample).max()

    port_ds = build_dataset(dict(opt, type="FFHQDataset"))
    loader = DataLoader(port_ds, batch_size=1, shuffle=False,
                        drop_last=False)
    (port_stats_in,) = list(calculate_fid_stats_from_datasets.dataset_batches(
        loader, 1, opt["mean"], opt["std"], "cpu"))
    port_sample_in = torch.clamp((_t(img) + 1) / 2, 0, 1)
    torch.testing.assert_close(port_stats_in, port_sample_in, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port_sample_in.numpy(), jax_sample_in,
                               rtol=0, atol=1e-6)


# ----------------------------------------------------------------- FID


def test_calculate_fid_matches_jax():
    """Random well-conditioned Gaussians at d = 64, and FID(X, X) = 0."""
    rng = np.random.default_rng(3)
    d = 64
    for _ in range(3):
        mu1, mu2 = rng.normal(size=(2, d))
        a, b = rng.normal(size=(2, d, d + 8))
        s1, s2 = a @ a.T / d, b @ b.T / d
        want = jax_fid(mu1, s1, mu2, s2)
        assert calculate_fid(mu1, s1, mu2, s2) == pytest.approx(want,
                                                                rel=1e-9)
    assert abs(calculate_fid(mu1, s1, mu1, s1)) < 1e-6 * np.trace(s1)
    with pytest.raises(ValueError, match="shapes"):
        calculate_fid(mu1, s1, mu2[:3], s2)


def test_calculate_fid_eps_branch_matches_jax(monkeypatch):
    """sigma1·sigma2 = [[0, 1], [0, 0]] has no square root: sqrtm gives
    non-finite values, and both sides retry on the eps-offset pair."""
    from scipy import linalg
    calls = []
    sqrtm = linalg.sqrtm

    def spy(*args, **kw):
        calls.append(1)
        return sqrtm(*args, **kw)

    monkeypatch.setattr(linalg, "sqrtm", spy)
    mu1, mu2 = np.zeros(2), np.array([0.5, -0.25])
    s1, s2 = np.array([[1.0, 0.0], [0.0, 0.0]]), np.array([[0.0, 1.0],
                                                          [1.0, 2.0]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_fid(mu1, s1, mu2, s2, eps=0.5)
        n_jax = len(calls)
        got = calculate_fid(mu1, s1, mu2, s2, eps=0.5)
    assert n_jax == 2 and len(calls) == 4
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-9)


# ---------------------------------------------------------- LPIPS, NIQE


@pytest.mark.parametrize("lin", [True, False], ids=["lin", "uniform"])
def test_lpips_matches_jax(tmp_path, lin):
    """LPIPS at 64² on 2 pairs, the same VGG16 (the port's seed-0 net saved
    as a torchvision state_dict) on both sides, with random lin weights
    from an lpips-style checkpoint or uniform ones: 1e-5 relative."""
    vgg = build_network(dict(type="VGGFeatureExtractor",
                             layer_name_list=("relu5_3",), vgg_type="vgg16",
                             use_input_norm=False),
                        torch.Generator().manual_seed(4))
    vgg_pth = tmp_path / "vgg16.pth"
    torch.save(vgg.state_dict(), str(vgg_pth))
    lin_pth = None
    if lin:
        g = torch.Generator().manual_seed(5)
        lins = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1),
                                                      generator=g)
                for i, c in enumerate((64, 128, 256, 512, 512))}
        lin_pth = str(tmp_path / "vgg.pth")
        torch.save(lins, lin_pth)
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(JaxLPIPS(lin_pth, str(vgg_pth))(a, b))
        fn = LPIPS(lin_pth, str(vgg_pth))
    with torch.no_grad():
        got = fn(_t(a), _t(b)).numpy()
        same = fn(_t(a), _t(a)).numpy()
    assert got.shape == (2,) and (got > 1e-4).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_lpips_without_weights_warns():
    with pytest.warns(UserWarning, match="calibrated"):
        LPIPS()


def test_niqe_matches_jax():
    rng = np.random.default_rng(7)
    img = cv2.GaussianBlur((rng.random((192, 192, 3)) * 255).astype(
        np.uint8), (5, 5), 1.0)
    want = jax_niqe(img, crop_border=0)
    got = calculate_niqe(img, crop_border=0)
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-9)


def test_calculate_metric_dispatch():
    """`calculate_metric` reaches PSNR, SSIM, NIQE, LPIPS and FID by their
    `type:` names, each equal to its direct call."""
    rng = np.random.default_rng(8)
    img = (rng.random((192, 192, 3)) * 255).astype(np.uint8)
    img2 = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(
        np.uint8)
    data = dict(img=img, img2=img2)
    assert calculate_metric(data, dict(type="calculate_psnr",
                                       crop_border=4)) == \
        calculate_psnr(img, img2, 4)
    assert calculate_metric(data, dict(type="calculate_ssim",
                                       crop_border=4)) == \
        calculate_ssim(img, img2, 4)
    assert calculate_metric(dict(img=img), dict(type="calculate_niqe",
                                                crop_border=0)) == \
        calculate_niqe(img, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = calculate_metric(dict(img=img[:64, :64], img2=img2[:64, :64]),
                             dict(type="calculate_lpips", device="cpu"))
        fn = LPIPS()
    a = _t(img[:64, :64, ::-1].copy()) / 255.0 * 2 - 1
    b = _t(img2[:64, :64, ::-1].copy()) / 255.0 * 2 - 1
    with torch.no_grad():
        assert d == pytest.approx(float(fn(a, b)), rel=1e-6)
    mu, s = np.zeros(4), np.eye(4)
    assert calculate_metric(dict(mu1=mu, sigma1=s, mu2=mu + 1, sigma2=s),
                            dict(type="calculate_fid")) == \
        pytest.approx(4.0, rel=1e-9)


# --------------------------------------------------- StyleGAN2 FID sample


TINY_G64 = dict(type="StyleGAN2OCRGenerator", input_width=64,
                input_height=64, num_style_feat=16, num_mlp=2,
                channel_multiplier=0.25, narrow=0.125)


def test_stylegan2_fid_sample_matches_jax():
    """The port's `sample` against the lines of JAX's
    `calculate_stylegan2_fid.py:56-73` (the mean latent as the mean of
    `return_latents`' first latent over 64 codes, truncation 0.7, no noise,
    [-1, 1] → [0, 1], bilinear resize to 299²) at a narrow 64² generator
    on the same codes: 1e-5 of max|ref|. The port's sample stays at 64²;
    the 299² resize is InceptionV3's own, applied here as the net does."""
    jnet = jax_build_network(dict(TINY_G64))
    shapes = jax.eval_shape(lambda k: jnet.init(k, [jnp.zeros((1, 16))]),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(9)

    def fill(path, s):  # modulation biases near their init of 1
        keys = [p.key for p in path]
        base = 1.0 if keys[-2:] == ["modulation", "bias"] else 0.0
        return (base + 0.5 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    net = build_network(dict(TINY_G64)).eval()
    net.load_state_dict(state_dict_from_jax(net, params))
    mean_codes = torch.randn((64, 16),
                             generator=torch.Generator().manual_seed(1))
    z = rng.standard_normal((3, 16)).astype(np.float32)

    @jax.jit
    def jax_sample(codes, z):
        latent = jnet.apply({"params": params}, [codes], return_latents=True,
                            randomize_noise=False)[1]
        trunc_latent = latent[:, 0, :].mean(0)
        img, _ = jnet.apply({"params": params}, [z], truncation=0.7,
                            truncation_latent=trunc_latent,
                            randomize_noise=False)
        return jax_resize(jnp.clip((img + 1) / 2, 0, 1), (299, 299),
                          "bilinear")

    want = np.asarray(jax_sample(jnp.asarray(mean_codes.numpy()),
                                 jnp.asarray(z)))
    with torch.no_grad():
        mean = net.mean_latent(64, torch.Generator().manual_seed(1))
        got = calculate_stylegan2_fid.sample(net, _t(z), 0.7, mean)
    assert got.shape == (3, 64, 64, 3)
    assert 0 <= got.min() and got.max() <= 1
    got = resize(got, (299, 299), "bilinear").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------------- CLIs


def test_fid_clis_on_cpu(tmp_path):
    """The statistics CLI over an lmdb of 3 images; the folder CLI on the
    source folder saves the same statistics (the same images at the same
    scale, so their FID would be 0; a 2048-d `sqrtm` takes seconds on the
    CPU, so `chip_smoke.py` phase 50 scores it); the StyleGAN2 FID CLI on a 16²
    generator checkpoint against the lmdb's statistics. All with
    `--device cpu`."""
    names = _images(tmp_path / "src", 3, (32, 32), 10)
    make_lmdb_from_imgs(str(tmp_path / "src"), str(tmp_path / "x.lmdb"),
                        names, [n[:-4] for n in names])
    stats = str(tmp_path / "stats.npz")
    calculate_fid_stats_from_datasets.main([
        "--dataroot", str(tmp_path / "x.lmdb"), "--io_backend", "lmdb",
        "--size", "32", "--num_sample", "3", "--batch_size", "2",
        "--save_path", stats, "--device", "cpu"])
    assert calculate_fid_folder.main([
        "--folder", str(tmp_path / "src"), "--save_stats_to",
        str(tmp_path / "folder.npz"), "--device", "cpu"]) is None
    with np.load(stats) as a, np.load(tmp_path / "folder.npz") as b:
        assert a["mean"].shape == (2048,) and a["cov"].shape == (2048, 2048)
        assert str(a["name"]) == "FFHQ" and int(a["size"]) == 32
        for k in ("mean", "cov"):
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=1e-5 * np.abs(a[k]).max())

    g = build_network(dict(type="StyleGAN2OCRGenerator", input_width=16,
                           input_height=16, num_style_feat=512, num_mlp=8,
                           channel_multiplier=2))
    ckpt = tmp_path / "net_g_2.pth"
    torch.save({"params_ema": g.state_dict()}, str(ckpt))
    fid_g = calculate_stylegan2_fid.main([
        str(ckpt), stats, "--size", "16", "--num_sample", "2",
        "--batch_size", "2", "--truncation", "0.7", "--truncation_mean",
        "64", "--device", "cpu"])
    assert np.isfinite(fid_g) and fid_g > 0


def _mixed_folder(folder):
    """Two 32² images and one 40 × 24 under `folder`."""
    _images(folder, 2, (32, 32), 13)
    _images(folder / "sub", 1, (40, 24), 14)
    os.replace(folder / "sub" / "00000.png", folder / "00002.png")
    os.rmdir(folder / "sub")


def test_fid_folder_batches(tmp_path):
    """The folder CLI's batches, on images of mixed sizes: RGB [0, 1] at
    299², each image equal to its own resize."""
    _mixed_folder(tmp_path)
    (batch,) = list(calculate_fid_folder.folder_batches(str(tmp_path),
                                                        "cpu"))
    assert batch.shape == (3, 299, 299, 3)
    for i, x in enumerate(batch):
        img = cv2.imread(str(tmp_path / f"{i:05d}.png"))[..., ::-1]
        want = resize(_t(img.copy()) / 255.0, (299, 299), "bilinear")
        torch.testing.assert_close(x, want, rtol=0, atol=1e-6)


def test_fid_folder_cli_matches_jax_script(inception_pth, tmp_path,
                                           monkeypatch):
    """The folder CLI's statistics against JAX's
    `scripts/metrics/calculate_fid_folder.py` on the same three images of
    mixed sizes and the same Inception weights. JAX resizes to 299² with
    `cv2.resize` on the host, the port with the cv2 bilinear matrix on the
    device: the means and covariances agree to 1e-4 of their max|ref|, as
    Inception's features do above."""
    _mixed_folder(tmp_path / "src")
    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _jax_cli(monkeypatch, "calculate_fid_folder", [
        "--folder", str(tmp_path / "src"), "--inception_weights",
        inception_pth, "--save_stats_to", jax_npz]).main()
    assert calculate_fid_folder.main([
        "--folder", str(tmp_path / "src"), "--inception_weights",
        inception_pth, "--save_stats_to", port_npz,
        "--device", "cpu"]) is None
    with np.load(jax_npz) as want, np.load(port_npz) as got:
        for k in ("mean", "cov"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-4 * np.abs(want[k]).max())


def test_image_metric_clis_on_cpu(tmp_path, monkeypatch):
    """The LPIPS (`--device cpu`), NIQE and PSNR/SSIM CLIs on two pairs at
    192² against the same-named scripts of `scripts/metrics/` on the same
    files, LPIPS with the same VGG16 and lin weights on both sides: each
    mean against the mean of the values the JAX script computed (LPIPS
    1e-5 relative, as above; NIQE 1e-9; PSNR and SSIM 1e-12), and the
    NIQE and PSNR/SSIM averages printed as JAX prints them."""
    _images(tmp_path / "gt", 2, (192, 192), 11)
    os.makedirs(tmp_path / "out")
    rng = np.random.default_rng(12)
    for i in range(2):
        gt = cv2.imread(str(tmp_path / "gt" / f"{i:05d}.png"))
        out = np.clip(gt + rng.normal(0, 10, gt.shape), 0, 255).astype(
            np.uint8)
        cv2.imwrite(str(tmp_path / "out" / f"{i:05d}_x.png"), out)
    vgg = build_network(dict(type="VGGFeatureExtractor",
                             layer_name_list=("relu5_3",), vgg_type="vgg16",
                             use_input_norm=False),
                        torch.Generator().manual_seed(4))
    vgg_pth, lin_pth = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save(vgg.state_dict(), vgg_pth)
    g = torch.Generator().manual_seed(5)
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1),
                                                     generator=g)
                for i, c in enumerate((64, 128, 256, 512, 512))}, lin_pth)
    pairs = ["--gt", str(tmp_path / "gt"), "--restored",
             str(tmp_path / "out"), "--suffix", "_x"]
    weights = ["--lpips_weights", lin_pth, "--vgg_weights", vgg_pth]

    buf = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(buf):
        warnings.simplefilter("ignore")
        mod = _jax_cli(monkeypatch, "calculate_lpips", pairs + weights)
        build, want_lp = mod.LPIPS, []

        def built(**kwargs):  # the script builds its metric: record that
            fn = build(**kwargs)
            return lambda a, b: want_lp.append(fn(a, b)) or want_lp[-1]

        monkeypatch.setattr(mod, "LPIPS", built)
        mod.main()
        got_lp = lpips_cli.main(pairs + weights + ["--device", "cpu"])
        mod = _jax_cli(monkeypatch, "calculate_niqe_folder",
                       ["--input", str(tmp_path / "out")])
        want_nq = _record(monkeypatch, mod, "calculate_niqe")
        mod.main()
        got_nq = calculate_niqe_folder.main(["--input",
                                             str(tmp_path / "out")])
        mod = _jax_cli(monkeypatch, "calculate_psnr_ssim", pairs)
        want_psnr = _record(monkeypatch, mod, "calculate_psnr")
        want_ssim = _record(monkeypatch, mod, "calculate_ssim")
        mod.main()
        got_psnr, got_ssim = calculate_psnr_ssim.main(pairs)
    assert len(want_lp) == len(want_nq) == len(want_psnr) == 2
    assert got_lp == pytest.approx(np.mean(want_lp), rel=1e-5)
    assert got_nq == pytest.approx(np.mean(want_nq), rel=1e-9)
    assert got_psnr == pytest.approx(np.mean(want_psnr), rel=1e-12)
    assert got_ssim == pytest.approx(np.mean(want_ssim), rel=1e-12)
    for word in ("Average NIQE", "Average PSNR"):
        jax_line, port_line = [line for line in buf.getvalue().splitlines()
                               if line.startswith(word)]
        assert port_line == jax_line


def test_device_clis_default_to_cuda(monkeypatch, tmp_path):
    """Without `--device`, the device CLIs take cuda and raise without a
    GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv, main in (
            (["--folder", str(tmp_path)], calculate_fid_folder.main),
            (["--gt", str(tmp_path), "--restored", str(tmp_path)],
             lpips_cli.main),
            (["--dataroot", str(tmp_path)],
             calculate_fid_stats_from_datasets.main),
            (["a.pth", "b.npz"], calculate_stylegan2_fid.main)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
