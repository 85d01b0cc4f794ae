"""The video slice's data side in the port against the JAX package on the
CPU.

* The eight video datasets against JAX's on the same tiny REDS and
  Vimeo-90K trees under one `random.seed`: keys, frame windows, crops and
  flips equal item by item; `generate_frame_indices` in its four padding
  modes and `duf_downsample` equal to JAX's; the training sets also read
  from the reference's lmdb layout. The finding: JAX's `val_partition:
  REDS4` (the string every REDS config writes) excludes no clip, the
  port's excludes the four.
* `scripts/regroup_reds_dataset.py` against JAX's script on a tiny tree;
  `scripts/generate_meta_info.py`'s REDS, REDS4 and Vimeo lists equal to
  JAX's, and its `--root` form matching a cut set.
* `IOUTracker` against JAX's on the same box stream; `VideoPipeline` on a
  tiny mp4v video with a CPU detector: its tracks are the tracker's on the
  detector's outputs, and the annotated video has every frame.
"""

import importlib.util
import os
import os.path as osp
import random

import cv2
import numpy as np
import pytest
import torch

from image_restoration_tpu.data import video_datasets as jvd
from image_restoration_tpu.serve import video as jvideo
from image_restoration_tpu_torch.data import video_datasets as tvd
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.scripts import generate_meta_info as tmeta
from image_restoration_tpu_torch.scripts import regroup_reds_dataset as tregroup
from image_restoration_tpu_torch.serve import video as tvideo
from image_restoration_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs

REPO = osp.normpath(osp.join(osp.dirname(__file__), os.pardir))
CLIPS = ("000", "001", "011")
VIMEO = ("00001/0001", "00001/0002")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(rel):
    spec = importlib.util.spec_from_file_location(
        "jax_" + osp.basename(rel)[:-3], osp.join(REPO, "scripts", rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path, img):
    os.makedirs(osp.dirname(path), exist_ok=True)
    cv2.imwrite(path, img)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """REDS layout (3 clips of 9 frames, GT 32×40, LQ ×1/4) with a meta
    file, its lmdbs, and Vimeo layout (2 septuplets, GT 32², LQ 8²)."""
    root = tmp_path_factory.mktemp("video")
    rng = np.random.default_rng(1800)
    for c in CLIPS:
        for f in range(9):
            gt = (rng.random((32, 40, 3)) * 255).astype(np.uint8)
            _write(str(root / "gt" / c / f"{f:08d}.png"), gt)
            _write(str(root / "lq" / c / f"{f:08d}.png"),
                   cv2.resize(gt, (10, 8), interpolation=cv2.INTER_AREA))
    for k in VIMEO:
        for i in range(1, 8):
            gt = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
            _write(str(root / "vgt" / k / f"im{i}.png"), gt)
            _write(str(root / "vlq" / k / f"im{i}.png"),
                   cv2.resize(gt, (8, 8), interpolation=cv2.INTER_AREA))
    tmeta.write_lines(tmeta.reds_lines(str(root / "gt")),
                      str(root / "meta.txt"))
    with open(root / "vmeta.txt", "w") as f:
        f.writelines(f"{k} 7 (32,32,3)\n" for k in VIMEO)
    for role in ("gt", "lq"):
        rels = [f"{c}/{f:08d}.png" for c in CLIPS for f in range(9)]
        make_lmdb_from_imgs(str(root / role), str(root / f"{role}.lmdb"),
                            rels, [r[:-4] for r in rels])
    return root


def _items(cls, opt, n, seed=1801):
    ds = cls(dict(opt))
    random.seed(seed)
    np.random.seed(seed)
    return ds, [ds[i] for i in range(n)]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def _reds_opt(trees, **kw):
    opt = dict(dataroot_gt=str(trees / "gt"), dataroot_lq=str(trees / "lq"),
               meta_info_file=str(trees / "meta.txt"), val_partition=["011"],
               num_frame=5, gt_size=16, scale=4, use_hflip=True,
               use_rot=True)
    return dict(opt, **kw)


@pytest.mark.parametrize("kind", ["REDSDataset", "REDSRecurrentDataset"])
@pytest.mark.parametrize("interval", [[1], [1, 2]])
def test_reds_datasets_match_jax(trees, kind, interval):
    """Every item of 18 keys (windows moved off the ends, random intervals
    and reversals, crops, flips and rotations) equal to JAX's."""
    opt = _reds_opt(trees, interval_list=interval, random_reverse=True)
    ds, got = _items(getattr(tvd, kind), opt, 18)
    jds, want = _items(getattr(jvd, kind), opt, 18)
    assert ds.keys == jds.keys and len(ds) == 18
    _assert_items_equal(got, want)


def test_reds_datasets_read_lmdb(trees):
    """`io_backend: {type: lmdb}` with lmdbs at the roots: the same items
    as from the folders."""
    opt = _reds_opt(trees)
    _, want = _items(tvd.REDSRecurrentDataset, opt, 6)
    _, got = _items(tvd.REDSRecurrentDataset, dict(
        opt, dataroot_gt=str(trees / "gt.lmdb"),
        dataroot_lq=str(trees / "lq.lmdb"), io_backend={"type": "lmdb"}), 6)
    _assert_items_equal(got, want)


def test_val_partition_reds4_finding(trees):
    """Every REDS config writes `val_partition: REDS4`. JAX tests each clip
    with `in` against that string, so no clip is left out and REDS4's
    clips (here 000 and 011) are trained on; the port leaves the four out,
    as the reference does."""
    opt = _reds_opt(trees, val_partition="REDS4")
    jkeys = jvd.REDSDataset(dict(opt)).keys
    keys = tvd.REDSDataset(dict(opt)).keys
    assert {k[:3] for k in jkeys} == set(CLIPS)
    assert {k[:3] for k in keys} == {"001"}
    assert tvd.val_clips("official")[0] == "240"
    with pytest.raises(ValueError):
        tvd.val_clips("REDS5")


@pytest.mark.parametrize("kind,extra", [
    ("Vimeo90KDataset", {"num_frame": 5}),
    ("Vimeo90KRecurrentDataset", {"flip_sequence": True,
                                  "random_reverse": True}),
])
def test_vimeo_datasets_match_jax(trees, kind, extra):
    opt = dict(dataroot_gt=str(trees / "vgt"), dataroot_lq=str(trees / "vlq"),
               meta_info_file=str(trees / "vmeta.txt"), gt_size=16, scale=4,
               **extra)
    _, got = _items(getattr(tvd, kind), opt, 2)
    _, want = _items(getattr(jvd, kind), opt, 2)
    _assert_items_equal(got, want)
    if extra.get("flip_sequence"):
        assert got[0]["lq"].shape == (14, 4, 4, 3)


@pytest.mark.parametrize("padding", ["replicate", "reflection",
                                     "reflection_circle", "circle"])
def test_frame_indices_and_test_datasets_match_jax(trees, padding):
    """`generate_frame_indices` at every index of 9- and 2-frame clips,
    then the sliding-window, whole-clip and DUF test sets item by item."""
    for total, num in ((9, 5), (9, 7), (2, 3)):
        for i in range(total):
            assert tvd.generate_frame_indices(i, total, num, padding) == \
                jvd.generate_frame_indices(i, total, num, padding)
    opt = dict(dataroot_gt=str(trees / "gt"), dataroot_lq=str(trees / "lq"),
               num_frame=5, padding=padding, scale=4)
    for kind, n in (("VideoTestDataset", 27),
                    ("VideoRecurrentTestDataset", 3)):
        _, got = _items(getattr(tvd, kind), opt, n)
        _, want = _items(getattr(jvd, kind), opt, n)
        _assert_items_equal(got, want)


def test_vimeo_and_duf_test_datasets_match_jax(trees):
    vopt = dict(dataroot_gt=str(trees / "vgt"), dataroot_lq=str(trees / "vlq"),
                meta_info_file=str(trees / "vmeta.txt"), num_frame=7)
    _, got = _items(tvd.VideoTestVimeo90KDataset, vopt, 2)
    _, want = _items(jvd.VideoTestVimeo90KDataset, vopt, 2)
    _assert_items_equal(got, want)
    dopt = dict(dataroot_gt=str(trees / "gt"), dataroot_lq=str(trees / "lq"),
                meta_info_file=str(trees / "meta.txt"), num_frame=7,
                padding="reflection_circle", scale=4,
                use_duf_downsampling=True)
    _, got = _items(tvd.VideoTestDUFDataset, dopt, 4)
    _, want = _items(jvd.VideoTestDUFDataset, dopt, 4)
    _assert_items_equal(got, want)
    assert got[0]["lq"].shape == (7, 8, 10, 3)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_duf_downsample_matches_jax(scale):
    x = np.random.default_rng(1802).random((2, 48, 36, 3))
    np.testing.assert_array_equal(tvd.duf_downsample(x, 13, scale),
                                  jvd.duf_downsample(x, 13, scale))


def test_build_dataset_knows_every_video_type(trees):
    for kind in ("REDSDataset", "REDSRecurrentDataset", "VideoTestDataset",
                 "VideoRecurrentTestDataset", "VideoTestDUFDataset"):
        ds = build_dataset(dict(_reds_opt(trees), type=kind, phase="val"))
        assert len(ds) > 0


# ---------------------------------------------------------------- scripts

def test_regroup_reds_matches_jax_script(tmp_path):
    """Both scripts on copies of one tree: the same folders and bytes."""
    rng = np.random.default_rng(1803)
    for side in ("t", "j"):
        for c in ("000", "001"):
            _write(str(tmp_path / side / "val" / c / "00000000.png"),
                   (rng.random((4, 4, 3)) * 0 + 7).astype(np.uint8))
        os.makedirs(tmp_path / side / "train" / "000")
    names = tregroup.regroup_reds_dataset(str(tmp_path / "t" / "train"),
                                          str(tmp_path / "t" / "val"))
    _jax_script("data_preparation/regroup_reds_dataset.py") \
        .regroup_reds_dataset(str(tmp_path / "j" / "train"),
                              str(tmp_path / "j" / "val"))
    assert names == ["240", "241"]
    for side in ("t", "j"):
        assert sorted(os.listdir(tmp_path / side / "train")) == \
            ["000", "240", "241"]
    assert (tmp_path / "t/train/241/00000000.png").read_bytes() == \
        (tmp_path / "j/train/241/00000000.png").read_bytes()


def test_generate_meta_info_matches_jax_script(tmp_path, trees):
    jmeta = _jax_script("data_preparation/generate_meta_info.py")
    for kind, lines in (("reds", tmeta.reds_lines()),
                        ("reds4", tmeta.reds_lines(test_only=True))):
        out = str(tmp_path / f"j_{kind}.txt")
        jmeta.main([kind, "--out", out])
        assert open(out).read().splitlines() == lines
    lst = tmp_path / "sep_trainlist.txt"
    lst.write_text("00001/0001\n00001/0002\n\n")
    jmeta.main(["vimeo", "--list", str(lst), "--out",
                str(tmp_path / "jv.txt")])
    got = tmeta.main(["vimeo", "--list", str(lst), "--out",
                      str(tmp_path / "tv.txt")])
    assert got == open(tmp_path / "jv.txt").read().splitlines()
    # the --root form: this tree's clips, frame counts and shapes
    assert tmeta.reds_lines(str(trees / "gt")) == \
        [f"{c} 9 (32,40,3)" for c in CLIPS]
    assert tmeta.reds_lines(str(trees / "gt"), test_only=True) == \
        ["000 9 (32,40,3)", "011 9 (32,40,3)"]
    assert open(trees / "meta.txt").read().splitlines() == \
        tmeta.reds_lines(str(trees / "gt"))


# ------------------------------------------------------ tracker, pipeline

def _box_stream(seed, frames=12):
    """Up to 3 drifting boxes a frame, one vanishing for 4 frames, plus a
    random one."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.1, 0.1, 0.3, 0.2], [0.5, 0.5, 0.7, 0.6],
                     [0.2, 0.6, 0.4, 0.8]], np.float32)
    out = []
    for f in range(frames):
        b = base + 0.01 * f
        keep = [0, 1] + ([2] if not 4 <= f < 8 else [])
        boxes = np.concatenate([b[keep], rng.random((1, 2), np.float32)
                                .repeat(2, 1) * [1, 1, 1.1, 1.1]])
        rng.shuffle(boxes)
        out.append((boxes, rng.random((len(boxes), 10), np.float32),
                    rng.random(len(boxes), np.float32)))
    return out


def test_iou_tracker_matches_jax():
    for max_misses in (2, 10):
        ours = tvideo.IOUTracker(0.3, max_misses)
        theirs = jvideo.IOUTracker(0.3, max_misses)
        for boxes, landms, scores in _box_stream(1804):
            a = ours.update(boxes, landms, scores)
            b = theirs.update(boxes, landms, scores)
            assert [(t.track_id, t.age, t.misses, t.score) for t in a] == \
                [(t.track_id, t.age, t.misses, t.score) for t in b]
            for t, u in zip(a, b):
                np.testing.assert_array_equal(t.box, u.box)
        assert [t.track_id for t in ours.tracks] == \
            [t.track_id for t in theirs.tracks]


def test_video_pipeline_on_a_tiny_video(tmp_path):
    """10 frames of 64×48 through mp4v, batch 4 (a short last batch): a
    result per frame, the tracks those of an IOUTracker fed the detector's
    own outputs, and an annotated video of 10 frames."""
    from image_restoration_tpu_torch.detect.engine import PlateDetector
    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 48))
    rng = np.random.default_rng(1805)
    frames = [(rng.random((48, 64, 3)) * 255).astype(np.uint8)
              for _ in range(10)]
    for f in frames:
        w.write(f)
    w.release()
    det = PlateDetector(backbone="mobilenet0.25", image_size=64,
                        score_threshold=0.0, device="cpu")
    pipe = tvideo.VideoPipeline(det, batch_size=4)
    res = pipe.run(src, dst)
    assert [i for i, _ in res] == list(range(10))
    cap = cv2.VideoCapture(src)
    decoded = [cap.read()[1] for _ in range(10)]
    tracker = tvideo.IOUTracker()
    for k in range(0, 10, 4):
        boxes, scores, landms, valid = pipe.detect_batch(decoded[k:k + 4])
        for i in range(len(boxes)):
            want = tracker.update(boxes[i][valid[i]], landms[i][valid[i]],
                                  scores[i][valid[i]])
            assert [t.track_id for t in res[k + i][1]] == \
                [t.track_id for t in want]
    assert any(tracks for _, tracks in res)
    out = cv2.VideoCapture(dst)
    assert int(out.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    with pytest.raises(IOError):
        pipe.run(str(tmp_path / "missing.mp4"))
