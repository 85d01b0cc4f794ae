"""The port's FLOP counter, profiler, restoration helper and data scripts
against the JAX package (and the root scripts) on the CPU.

  * `count_flops` equals JAX's `count_flops` on the cases of
    tests/test_flops.py that have an eager meaning (a matmul, a conv with
    groups and a depthwise one, the gradient of a matmul), exactly; on a
    narrow GFPGANv1OCR forward the port's count plus `dilation_extra` (the
    zeros JAX's lhs-dilated transposed convs multiply) equals JAX's
    exactly, the matmul part unchanged; at PRODUCTION_GFPGAN (on the meta
    device) it is held beside chip_smoke.py's `analytic_gfpgan_flops`;
  * `trace` writes a Chrome trace holding an `annotate` span, and
    `trace_training_window` one per step;
  * `RestorationHelper` equals JAX's at the same detections (crops,
    affines, paste-back) and runs on the port's `PlateDetector`;
  * the tfrecord reader on test_utils_extra.py's hand-encoded record, and
    both converters against the root script's; `generate_meta_info
    folder` byte-equal to the root script's `gen_folder`.
"""

import importlib.util
import json
import os
import struct
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_tpu.archs import build_network as jax_build
from image_restoration_tpu.utils import face_util as jface
from image_restoration_tpu.utils.flops import count_flops as jax_count
from image_restoration_tpu_torch.archs import build_network
from image_restoration_tpu_torch.infer import PRODUCTION_GFPGAN
from image_restoration_tpu_torch.ops import fused_act
from image_restoration_tpu_torch.scripts import \
    extract_images_from_tfrecords as tfrec
from image_restoration_tpu_torch.scripts import generate_meta_info
from image_restoration_tpu_torch.utils import face_util, profiler
from image_restoration_tpu_torch.utils.flops import (count_flops,
                                                     dilation_extra)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- flops

def test_matmul_and_grad_match_jax():
    a, b = np.zeros((8, 64), np.float32), np.zeros((64, 32), np.float32)
    want = jax_count(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    got = count_flops(lambda a, b: a @ b, torch.from_numpy(a),
                      torch.from_numpy(b))
    assert got["total"] == want["total"] == 2 * 8 * 64 * 32
    assert got["matmul"] == got["total"] and got["conv"] == 0
    assert got["flags"] == [] and len(got["top_shapes"]) == 1
    want = jax_count(jax.grad(lambda a, b: jnp.sum(a @ b), argnums=(0, 1)),
                     jnp.asarray(a), jnp.asarray(b))
    ta = torch.zeros(8, 64, requires_grad=True)
    tb = torch.zeros(64, 32, requires_grad=True)
    got = count_flops(lambda: (ta @ tb).sum().backward())
    assert got["total"] == want["total"] == 3 * 2 * 8 * 64 * 32


@pytest.mark.parametrize("groups", [1, 8])
def test_conv_with_groups_matches_jax(groups):
    cout = 24 if groups == 1 else 8
    x = jnp.zeros((2, 16, 16, 8))
    w = jnp.zeros((3, 3, 8 // groups, cout))
    want = jax_count(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC")), x, w)
    got = count_flops(lambda x, w: F.conv2d(x, w, padding=1, groups=groups),
                      torch.zeros(2, 8, 16, 16),
                      torch.zeros(cout, 8 // groups, 3, 3))
    assert got["total"] == want["total"] == \
        2 * (2 * 16 * 16 * cout) * (8 // groups) * 9
    assert got["conv"] == got["total"]
    assert got["top_shapes"][0][0] == \
        f"convolution[2x8x16x16,{cout}x{8 // groups}x3x3->2x{cout}x16x16]"


NARROW = dict(type="GFPGANv1OCR", input_width=32, input_height=32,
              num_style_feat=16, channel_multiplier=0.25, num_mlp=2,
              input_is_latent=True, different_w=True, narrow=0.5,
              sft_half=True)


def test_gfpgan_forward_matches_jax_up_to_the_dilated_zeros():
    net = build_network(NARROW).eval()
    with torch.no_grad():
        got = count_flops(lambda x: net(x, return_rgb=True,
                                        randomize_noise=False),
                          torch.zeros(2, 32, 32, 3), top=10_000)
    jnet = jax_build(NARROW)
    x = jnp.zeros((2, 32, 32, 3))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    shapes)
    want = jax_count(lambda p, x: jnet.apply(p, x, randomize_noise=False),
                     params, x)
    extra = dilation_extra(got["top_shapes"])
    assert got["matmul"] == want["matmul"]
    assert got["total"] + extra == want["total"]
    assert 0 < extra < got["total"]


def test_production_gfpgan_count_beside_the_analytic_estimate():
    """At PRODUCTION_GFPGAN a bs-1 training forward counts 36.90 GFLOP in
    the port (49.65 the JAX way, the dilated zeros included), where
    `analytic_gfpgan_flops` takes 85 GFLOP for G's forward: the analytic
    step estimate is 1.71× the counted one for G."""
    smoke = _load(os.path.join(REPO, "chip_smoke.py"), "chip_smoke_flops")
    net = build_network(PRODUCTION_GFPGAN).eval().to("meta")
    # shapes only: K1's wrapper takes CPU or CUDA tensors, its plain
    # version any device
    with torch.no_grad(), mock.patch.object(
            fused_act, "fused_leaky_relu", fused_act.fused_leaky_relu_plain):
        got = count_flops(lambda x: net(x, return_rgb=True,
                                        randomize_noise=False),
                          torch.empty(1, 256, 256, 3, device="meta"),
                          top=10_000)
    jax_way = got["total"] + dilation_extra(got["top_shapes"])
    assert round(got["total"] / 1e9, 2) == 36.90
    assert round(jax_way / 1e9, 2) == 49.65
    g_fwd = smoke.analytic_gfpgan_flops(1) - smoke.analytic_gfpgan_flops(0)
    g_analytic = g_fwd - (18e9 * 7 + 51e9 * 4)  # its D and VGG terms
    assert g_analytic == 3 * 85e9
    assert 1.6 < (g_analytic / 3) / jax_way < 1.8


# ------------------------------------------------------------- profiler

def test_trace_holds_the_annotated_span(tmp_path):
    with profiler.trace(str(tmp_path)):
        with profiler.annotate("port_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    with pytest.raises(NotImplementedError, match="profiler server"):
        profiler.start_server()


def test_trace_training_window(tmp_path):
    class Steps:
        calls = []

        def optimize_parameters(self, it, batch, gen):
            self.calls.append(it)
            torch.ones(8, 8) @ batch

    model = Steps()
    profiler.trace_training_window(model, [torch.ones(8, 8)] * 2,
                                   torch.Generator(), str(tmp_path),
                                   num_steps=3, start_iter=5)
    assert model.calls == [5, 6, 7, 8]
    names = {e.get("name") for e in json.load(
        open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"train_step_1", "train_step_2", "train_step_3"} <= names


# --------------------------------------------------- restoration helper

class _Detector:
    """Fixed detections: two regions, the second not valid."""

    def detect_image(self, img):
        rows = []
        for x1, y1, x2, y2 in ((32, 24, 96, 72), (4, 4, 20, 20)):
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            rows.append([x1, y1, x2, y2 - 6, cx + 3, cy, x1 + 2, y2,
                         x2, y2])
        landms = np.asarray(rows, np.float32)
        return (np.zeros((2, 4), np.float32), np.asarray([0.9, 0.8]),
                landms, np.asarray([True, False]))


@pytest.mark.parametrize("up", [1, 2])
def test_restoration_helper_matches_jax(up):
    img = (np.random.default_rng(0).random((96, 128, 3)) * 255
           ).astype(np.uint8)
    helpers = [m.RestorationHelper(detector=_Detector(), face_size=64,
                                   upscale_factor=up)
               for m in (face_util, jface)]
    outs = []
    for h in helpers:
        assert h.detect_landmarks(img) == 1
        crops = h.warp_crop_faces()
        h.add_restored_face(255 - crops[0])  # a visible "restore"
        outs.append(h.paste_faces_to_input_image())
    np.testing.assert_array_equal(helpers[0].landmarks[0],
                                  helpers[1].landmarks[0])
    np.testing.assert_array_equal(helpers[0].affine_matrices[0],
                                  helpers[1].affine_matrices[0])
    np.testing.assert_array_equal(helpers[0].cropped_faces[0],
                                  helpers[1].cropped_faces[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (96 * up, 128 * up, 3)


def test_restoration_helper_on_the_port_detector():
    from image_restoration_tpu_torch.detect.engine import PlateDetector
    helper = face_util.RestorationHelper(
        detector=PlateDetector(backbone="mobilenet0.25", image_size=64,
                               score_threshold=0.0, device="cpu"),
        face_size=32)
    img = (np.random.default_rng(1).random((48, 64, 3)) * 255
           ).astype(np.uint8)
    n = helper.detect_landmarks(img)
    assert n >= 1
    crops = helper.warp_crop_faces()
    assert len(crops) == n and all(c.shape == (32, 32, 3) for c in crops)
    restored = helper.restore_faces(lambda rgb: (rgb[..., ::-1] * 255)
                                    .round().astype(np.uint8))
    for a, b in zip(restored, crops):
        np.testing.assert_array_equal(a, b)
    assert helper.paste_faces_to_input_image().shape == img.shape


# ---------------------------------------------------------- data scripts

def _varint(n):
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _field(num, wire, payload):
    key = _varint((num << 3) | wire)
    return key + (_varint(len(payload)) + payload if wire == 2 else payload)


def _example(data: bytes, shape, packed=False):
    """test_utils_extra.py's hand-encoded tf.train.Example (with the
    int64 list packed, as TensorFlow writes it, when `packed`)."""
    feat_data = _field(1, 2, _field(1, 2, data))
    entry_data = _field(1, 2, b"data") + _field(2, 2, feat_data)
    if packed:
        ints = _field(1, 2, b"".join(_varint(v) for v in shape))
    else:
        ints = b"".join(_field(1, 0, _varint(v)) for v in shape)
    entry_shape = _field(1, 2, b"shape") + _field(2, 2, _field(3, 2, ints))
    return _field(1, 2, _field(1, 2, entry_data) + _field(1, 2, entry_shape))


def _write_records(path, examples):
    with open(path, "wb") as f:
        for ex in examples:
            f.write(struct.pack("<Q", len(ex)) + b"\0\0\0\0" + ex
                    + b"\0\0\0\0")


def test_tfrecord_example_parser_roundtrip(tmp_path):
    rec = tmp_path / "toy.tfrecords"
    _write_records(rec, [_example(bytes(range(12)), (3, 2, 2)),
                         _example(bytes(range(12)), (3, 2, 2), packed=True)])
    records = list(tfrec.iter_tfrecord(str(rec)))
    assert len(records) == 2
    for r in records:
        feats = tfrec.parse_example(r)
        assert feats["shape"] == [3, 2, 2]
        assert feats["data"][0] == bytes(range(12))


@pytest.mark.parametrize("dataset, save_type",
                         [("ffhq", "img"), ("ffhq", "lmdb"),
                          ("celeba", "img")])
def test_tfrecord_converters_match_the_root_script(tmp_path, dataset,
                                                   save_type):
    root = _load(os.path.join(REPO, "scripts", "data_preparation",
                              "extract_images_from_tfrecords.py"),
                 "root_tfrec")
    rng = np.random.default_rng(2)
    shape = (3, 8, 6) if dataset == "ffhq" else (8, 6, 3)
    imgs = [(rng.random(shape) * 255).astype(np.uint8) for _ in range(3)]
    _write_records(tmp_path / "a.tfrecords",
                   [_example(i.tobytes(), shape) for i in imgs])
    outs = []
    for mod, name in ((tfrec, "port"), (root, "root")):
        fn = getattr(mod, f"convert_{dataset}_tfrecords")
        fn(str(tmp_path / "*.tfrecords"), 3, str(tmp_path / name),
           save_type)
        outs.append(tmp_path / name)
    for rel in sorted(os.listdir(outs[1])):
        a, b = outs[0] / rel, outs[1] / rel
        if a.is_dir():
            for f in sorted(os.listdir(b)):
                assert (a / f).read_bytes() == (b / f).read_bytes(), f
        else:
            assert a.read_bytes() == b.read_bytes()
    if save_type == "img":
        got = cv2.imread(str(next(outs[0].iterdir()) / "00000001.png"))
        want = imgs[1].transpose(1, 2, 0) if dataset == "ffhq" else imgs[1]
        np.testing.assert_array_equal(got, want[..., ::-1])


def test_generate_meta_info_folder_byte_equal(tmp_path):
    root = _load(os.path.join(REPO, "scripts", "data_preparation",
                              "generate_meta_info.py"), "root_meta")
    folder = tmp_path / "gt"
    folder.mkdir()
    rng = np.random.default_rng(3)
    for i, shape in enumerate([(9, 7, 3), (5, 11), (6, 6, 3)]):
        cv2.imwrite(str(folder / f"img_{i}.png"),
                    (rng.random(shape) * 255).astype(np.uint8))
    (folder / "notes.txt").write_text("not an image")
    root.gen_folder(str(folder), str(tmp_path / "want.txt"))
    generate_meta_info.main(["folder", "--root", str(folder), "--out",
                             str(tmp_path / "got.txt")])
    assert (tmp_path / "got.txt").read_bytes() == \
        (tmp_path / "want.txt").read_bytes()
    assert b"img_1.png (5,11,3)" in (tmp_path / "got.txt").read_bytes()
