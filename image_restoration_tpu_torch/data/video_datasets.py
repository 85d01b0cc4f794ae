"""Video SR datasets: clips read, cropped and flipped on the host.

Port of `image_restoration_tpu/data/video_datasets.py`, under the same
`type:` names: `REDSDataset` (:23), `REDSRecurrentDataset` (:109),
`Vimeo90KDataset` (:141), `Vimeo90KRecurrentDataset` (:177),
`VideoTestVimeo90KDataset` (:214), `VideoTestDataset` (:284),
`VideoRecurrentTestDataset` (:364) and `VideoTestDUFDataset` (:387), with
`generate_frame_indices` (:248), `duf_downsample` (:329) and `mod_crop`
(:358). Clips are (T, H, W, 3) float32 RGB; the loader stacks them into
(N, T, H, W, 3) batches. The random draws are Python's `random` (and
numpy's nowhere), as in JAX, so one seed gives the same items.

Every set reads a clip's files in order and decodes them on a pool of
threads (cv2's decode releases the interpreter lock; a REDS training item
is 30–60 PNGs of up to 720×1280), so the random draws stay in JAX's order.
The training sets read frames through `utils/file_client.py`: from disk
(`<root>/<clip>/<frame:08d>.png`, `<root>/<key>/im<i>.png`) or, with
`io_backend: {type: lmdb}`, from the reference's lmdbs at `dataroot_lq`
and `dataroot_gt` under the same keys without the extension. The test sets
list their folders on disk, as JAX's do. `val_partition` takes the
reference's names, 'REDS4' (clips 000, 011, 015, 020) and 'official'
(240–269), or a list of clips; JAX tests a clip against the string itself,
so 'REDS4' excludes nothing there (ROADMAP Queue 3).
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from os import path as osp

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes
from ..utils.misc import scandir
from ..utils.registry import DATASET_REGISTRY
from .transforms import augment, paired_random_crop

REDS4 = ["000", "011", "015", "020"]


def val_clips(partition) -> list:
    """The clips a `val_partition` option names."""
    if partition == "REDS4":
        return list(REDS4)
    if partition == "official":
        return [f"{v:03d}" for v in range(240, 270)]
    if isinstance(partition, str):
        raise ValueError(f"unknown val_partition {partition!r}: 'REDS4', "
                         "'official' or a list of clips")
    return list(partition or [])


def _rgb_stack(frames) -> np.ndarray:
    return np.stack([f[..., ::-1] for f in frames]).copy()


class _Decoder:
    """Decodes encoded images to float32 BGR on a pool of threads, made at
    first use."""

    def __init__(self, threads: int = 8):
        self.threads, self._pool = threads, None

    def __call__(self, datas) -> list:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.threads)
        return list(self._pool.map(
            lambda d: imfrombytes(d, float32=True), datas))


class _ClipReader:
    """Frames by key (`clip/frame`, no extension) from disk or lmdb."""

    def __init__(self, opt: dict):
        io = dict(opt.get("io_backend") or {"type": "disk"})
        backend = io.pop("type", "disk")
        self.roots = {"lq": opt["dataroot_lq"], "gt": opt["dataroot_gt"]}
        self.lmdb = backend == "lmdb"
        if self.lmdb:
            self.client = FileClient(
                "lmdb", db_paths=[self.roots["lq"], self.roots["gt"]],
                client_keys=["lq", "gt"])
        else:
            self.client = FileClient(backend, **io)
        self.decode = _Decoder()

    def read(self, role: str, keys) -> list:
        """The frames of `keys`, read in order, decoded in parallel."""
        if self.lmdb:
            datas = [self.client.get(k, role) for k in keys]
        else:
            datas = [self.client.get(osp.join(self.roots[role], k + ".png"))
                     for k in keys]
        return self.decode(datas)


@DATASET_REGISTRY.register()
class REDSDataset:
    """REDS training items: `num_frame` LQ neighbours (at a random
    interval) around a centre frame and its GT, cropped and flipped
    together. Keys are `clip/frame` over the meta-info file's clips (or
    the GT folder's), without the `val_partition` clips."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.num_frame = opt.get("num_frame", 5)
        self.num_half = self.num_frame // 2
        self.reader = _ClipReader(opt)
        self.clip_frames = {}
        self.keys = []
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"]) as f:
                for line in f:
                    clip, num = line.strip().split(" ")[:2]
                    self.clip_frames[clip] = int(num)
                    self.keys.extend(f"{clip}/{i:08d}"
                                     for i in range(int(num)))
        else:
            root = opt["dataroot_gt"]
            for clip in sorted(d for d in os.listdir(root)
                               if osp.isdir(osp.join(root, d))):
                frames = sorted(scandir(osp.join(root, clip)))
                self.clip_frames[clip] = len(frames)
                self.keys.extend(f"{clip}/{osp.splitext(f)[0]}"
                                 for f in frames)
        excluded = set(val_clips(opt.get("val_partition", REDS4)))
        self.keys = [k for k in self.keys if k.split("/")[0] not in excluded]
        self.interval_list = opt.get("interval_list", [1])
        self.random_reverse = opt.get("random_reverse", False)

    def __len__(self):
        return len(self.keys)

    def device_pipeline(self):
        return None  # the LQ frames are rendered on disk

    def neighbours(self, key: str):
        """(clip, centre, [frame indices]) of an item: the window moved to
        a random valid centre where it would leave the clip."""
        clip, frame = key.split("/")
        center = int(frame)
        interval = random.choice(self.interval_list)
        half = self.num_half * interval
        max_frame = self.clip_frames.get(clip, 100) - 1
        while center - half < 0 or center + half > max_frame:
            center = random.randint(half, max_frame - half)
        frames = list(range(center - half, center + half + 1, interval))
        if self.random_reverse and random.random() < 0.5:
            frames.reverse()
        return clip, center, frames

    def __getitem__(self, index):
        key = self.keys[index]
        clip, center, frames = self.neighbours(key)
        lqs = self.reader.read("lq", [f"{clip}/{i:08d}" for i in frames])
        (gt,) = self.reader.read("gt", [f"{clip}/{center:08d}"])
        gt, lqs = paired_random_crop(gt, lqs, self.opt.get("gt_size", 256),
                                     self.opt.get("scale", 4))
        out = augment(_as_list(lqs) + [gt], self.opt.get("use_hflip", True),
                      self.opt.get("use_rot", True))
        return {"lq": _rgb_stack(out[:-1]), "gt": out[-1][..., ::-1].copy(),
                "key": key}


@DATASET_REGISTRY.register()
class REDSRecurrentDataset(REDSDataset):
    """`num_frame` consecutive LQ and GT frames from the key's frame (a
    random start where the clip is too short), for the recurrent nets."""

    def window(self, key: str):
        clip, frame = key.split("/")
        start = int(frame)
        total = self.clip_frames.get(clip, 100)
        if start > total - self.num_frame:
            start = random.randint(0, total - self.num_frame)
        return clip, list(range(start, start + self.num_frame))

    def __getitem__(self, index):
        key = self.keys[index]
        clip, frames = self.window(key)
        lqs = self.reader.read("lq", [f"{clip}/{i:08d}" for i in frames])
        gts = self.reader.read("gt", [f"{clip}/{i:08d}" for i in frames])
        gts, lqs = paired_random_crop(gts, lqs, self.opt.get("gt_size", 256),
                                      self.opt.get("scale", 4))
        t = len(frames)
        out = augment(_as_list(lqs) + _as_list(gts),
                      self.opt.get("use_hflip", True),
                      self.opt.get("use_rot", True))
        return {"lq": _rgb_stack(out[:t]), "gt": _rgb_stack(out[t:]),
                "key": key}


def _as_list(x):
    return list(x) if isinstance(x, list) else [x]


@DATASET_REGISTRY.register()
class Vimeo90KDataset:
    """Vimeo-90K septuplets: the `num_frame` LQ frames around im4 and im4's
    GT."""

    def __init__(self, opt: dict):
        self.opt = opt
        with open(opt["meta_info_file"]) as f:
            self.keys = [line.strip().split(" ")[0] for line in f]
        self.reader = _ClipReader(opt)
        num_frame = opt.get("num_frame", 7)
        self.neighbor_list = [i + (9 - num_frame) // 2
                              for i in range(num_frame)]

    def __len__(self):
        return len(self.keys)

    def device_pipeline(self):
        return None

    def __getitem__(self, index):
        key = self.keys[index]
        (gt,) = self.reader.read("gt", [f"{key}/im4"])
        lqs = self.reader.read("lq", [f"{key}/im{i}"
                                      for i in self.neighbor_list])
        gt, lqs = paired_random_crop(gt, lqs, self.opt.get("gt_size", 256),
                                     self.opt.get("scale", 4))
        out = augment(_as_list(lqs) + [gt], self.opt.get("use_hflip", True),
                      self.opt.get("use_rot", True))
        return {"lq": _rgb_stack(out[:-1]), "gt": out[-1][..., ::-1].copy(),
                "key": key}


@DATASET_REGISTRY.register()
class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    """All seven LQ and GT frames; `random_reverse` reverses time,
    `flip_sequence` mirrors the clip to 14 frames."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.flip_sequence = opt.get("flip_sequence", False)
        self.random_reverse = opt.get("random_reverse", False)
        self.neighbor_list = [1, 2, 3, 4, 5, 6, 7]

    def __getitem__(self, index):
        key = self.keys[index]
        frames = list(self.neighbor_list)
        if self.random_reverse and random.random() < 0.5:
            frames.reverse()
        lqs = self.reader.read("lq", [f"{key}/im{i}" for i in frames])
        gts = self.reader.read("gt", [f"{key}/im{i}" for i in frames])
        gts, lqs = paired_random_crop(gts, lqs, self.opt.get("gt_size", 256),
                                      self.opt.get("scale", 4))
        t = len(frames)
        out = augment(_as_list(lqs) + _as_list(gts),
                      self.opt.get("use_hflip", True),
                      self.opt.get("use_rot", True))
        lq, gt = _rgb_stack(out[:t]), _rgb_stack(out[t:])
        if self.flip_sequence:
            lq = np.concatenate([lq, lq[::-1]], axis=0)
            gt = np.concatenate([gt, gt[::-1]], axis=0)
        return {"lq": lq.copy(), "gt": gt.copy(), "key": key}


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset:
    """Vimeo-90K test: `num_frame` LQ neighbours of im4 and im4's GT, one
    item per meta-info line, folder 'vimeo90k'."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.roots = {"lq": opt["dataroot_lq"], "gt": opt["dataroot_gt"]}
        num_frame = opt.get("num_frame", 7)
        self.neighbor_list = [i + (9 - num_frame) // 2
                              for i in range(num_frame)]
        self.client = FileClient("disk")
        self.decode = _Decoder()
        with open(opt["meta_info_file"]) as f:
            self.subfolders = [line.strip().split(" ")[0] for line in f]

    def __len__(self):
        return len(self.subfolders)

    def device_pipeline(self):
        return None

    def _read(self, role, paths):
        return self.decode([self.client.get(osp.join(self.roots[role], p))
                            for p in paths])

    def __getitem__(self, index):
        sub = self.subfolders[index]
        lqs = self._read("lq", [f"{sub}/im{i}.png"
                                for i in self.neighbor_list])
        (gt,) = self._read("gt", [f"{sub}/im4.png"])
        return {"lq": _rgb_stack(lqs), "gt": gt[..., ::-1].copy(),
                "folder": "vimeo90k", "idx": index}


def generate_frame_indices(crt_idx: int, max_frame_num: int,
                           num_frames: int, padding: str = "reflection"):
    """The `num_frames` indices around `crt_idx` in a clip of
    `max_frame_num` frames, the ends padded by `padding`: replicate,
    reflection, reflection_circle or circle (at crt_idx 0 of 5:
    [0,0,0,1,2], [2,1,0,1,2], [4,3,0,1,2], [3,4,0,1,2])."""
    if num_frames % 2 != 1:
        raise ValueError("num_frames should be an odd number.")
    if padding not in ("replicate", "reflection", "reflection_circle",
                       "circle"):
        raise ValueError(f"wrong padding mode: {padding}")
    last = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            i = {"replicate": 0, "reflection": -i,
                 "reflection_circle": crt_idx + num_pad - i,
                 "circle": num_frames + i}[padding]
        elif i > last:
            i = {"replicate": last, "reflection": last * 2 - i,
                 "reflection_circle": (crt_idx - num_pad) - (i - last),
                 "circle": i - num_frames}[padding]
        indices.append(i)
    return indices


@DATASET_REGISTRY.register()
class VideoTestDataset:
    """Per-folder evaluation: for every frame of every folder, the
    `num_frame` LQ frames around it (ends padded by `padding`) and its GT.
    Folders from the meta-info file, or every folder under the LQ root."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.roots = {"lq": opt["dataroot_lq"], "gt": opt["dataroot_gt"]}
        self.num_frame = opt.get("num_frame", 5)
        self.padding = opt.get("padding", "reflection")
        self.client = FileClient("disk")
        self.decode = _Decoder()
        if opt.get("meta_info_file"):
            with open(opt["meta_info_file"]) as f:
                self.folders = [line.strip().split(" ")[0] for line in f]
        else:
            root = self.roots["lq"]
            self.folders = sorted(d for d in os.listdir(root)
                                  if osp.isdir(osp.join(root, d)))
        self.frames = {(role, folder): sorted(scandir(osp.join(root, folder)))
                       for role, root in self.roots.items()
                       for folder in self.folders}
        self.items = [(folder, i, len(self.frames["lq", folder]))
                      for folder in self.folders
                      for i in range(len(self.frames["lq", folder]))]

    def __len__(self):
        return len(self.items)

    def device_pipeline(self):
        return None

    def _frames(self, role, folder, idxs) -> list:
        """Frames `idxs` of `folder`, read in order, decoded in parallel."""
        names = self.frames[role, folder]
        return self.decode([self.client.get(
            osp.join(self.roots[role], folder, names[i])) for i in idxs])

    def __getitem__(self, index):
        folder, i, total = self.items[index]
        idxs = generate_frame_indices(i, total, self.num_frame, self.padding)
        lqs = self._frames("lq", folder, idxs)
        (gt,) = self._frames("gt", folder, [i])
        return {"lq": _rgb_stack(lqs), "gt": gt[..., ::-1].copy(),
                "folder": folder, "idx": i}


def duf_downsample(x: np.ndarray, kernel_size: int = 13,
                   scale: int = 4) -> np.ndarray:
    """DUF's official Gaussian downsampling of (T, H, W, C) frames: σ =
    0.4·scale, reflect padding, every `scale`-th pixel, 2 trimmed at each
    edge."""
    if scale not in (2, 3, 4):
        raise ValueError(f"Only support scale (2, 3, 4), got {scale}")
    from scipy import signal
    g1 = signal.windows.gaussian(kernel_size, std=0.4 * scale)
    kernel = np.outer(g1, g1)
    kernel /= kernel.sum()
    pad = kernel_size // 2 + scale * 2
    out = []
    for frame in x:
        chans = []
        for ci in range(frame.shape[-1]):
            img = np.pad(frame[:, :, ci], pad, mode="reflect")
            blurred = signal.convolve2d(img, kernel, mode="valid")
            chans.append(blurred[::scale, ::scale][2:-2, 2:-2])
        out.append(np.stack(chans, axis=-1))
    return np.stack(out)


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[:h - h % scale, :w - w % scale]


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset(VideoTestDataset):
    """One item per folder: its whole LQ and GT clips."""

    def __len__(self):
        return len(self.folders)

    def __getitem__(self, index):
        folder = self.folders[index]
        idxs = range(len(self.frames["lq", folder]))
        return {"lq": _rgb_stack(self._frames("lq", folder, idxs)),
                "gt": _rgb_stack(self._frames("gt", folder, idxs)),
                "folder": folder}


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """VideoTestDataset whose LQ frames, with `use_duf_downsampling`, are
    DUF's Gaussian downsampling of the mod-cropped GT frames; the GT is
    mod-cropped to `scale`."""

    def __getitem__(self, index):
        folder, i, total = self.items[index]
        idxs = generate_frame_indices(i, total, self.num_frame, self.padding)
        scale = self.opt.get("scale", 4)
        if self.opt.get("use_duf_downsampling"):
            gts = np.stack([mod_crop(f, scale)
                            for f in self._frames("gt", folder, idxs)])
            lqs = duf_downsample(gts, kernel_size=13, scale=scale)
        else:
            lqs = np.stack(self._frames("lq", folder, idxs))
        gt = mod_crop(self._frames("gt", folder, [i])[0], scale)
        return {"lq": np.ascontiguousarray(lqs[..., ::-1]),
                "gt": np.ascontiguousarray(gt[..., ::-1]),
                "folder": folder, "idx": i}
