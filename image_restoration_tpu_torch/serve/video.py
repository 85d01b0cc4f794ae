"""Video-stream plate detection: decode, batched detection, IOU tracking,
annotation and writing.

Port of `image_restoration_tpu/serve/video.py` (`_iou` :26, `IOUTracker`
:47, `VideoPipeline` :82), the role of the reference's DeepStream app:
frames decoded with cv2, detected in batches by the port's `PlateDetector`
(on the card unless `device` says otherwise), associated across frames by a
greedy IOU tracker, boxed and labelled, and written to an mp4v video:

    VideoPipeline(PlateDetector(ckpt_path="D.pth")).run("in.mp4", "out.mp4")
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import cv2
import numpy as np

from ..detect.engine import PlateDetector


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-8)


@dataclass
class Track:
    track_id: int
    box: np.ndarray
    landmarks: np.ndarray
    score: float
    age: int = 0
    misses: int = 0


class IOUTracker:
    """Greedy IOU association: each track, in order, takes the unmatched
    box it overlaps most above `iou_threshold`; a track unmatched for more
    than `max_misses` frames ends; each box left over starts a track."""

    def __init__(self, iou_threshold: float = 0.3, max_misses: int = 10):
        self.iou_threshold = iou_threshold
        self.max_misses = max_misses
        self.tracks: List[Track] = []
        self._next_id = 0

    def update(self, boxes: np.ndarray, landms: np.ndarray,
               scores: np.ndarray) -> List[Track]:
        """The tracks seen in this frame."""
        unmatched = list(range(len(boxes)))
        for track in self.tracks:
            best, best_iou = -1, self.iou_threshold
            for j in unmatched:
                iou = _iou(track.box, boxes[j])
                if iou > best_iou:
                    best, best_iou = j, iou
            if best >= 0:
                track.box, track.landmarks = boxes[best], landms[best]
                track.score = float(scores[best])
                track.age += 1
                track.misses = 0
                unmatched.remove(best)
            else:
                track.misses += 1
        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]
        for j in unmatched:
            self.tracks.append(Track(self._next_id, boxes[j], landms[j],
                                     float(scores[j])))
            self._next_id += 1
        return [t for t in self.tracks if t.misses == 0]


class VideoPipeline:
    """Frame loop: batch-detect → track → annotate → write."""

    def __init__(self, detector: Optional[PlateDetector] = None,
                 batch_size: int = 4, score_threshold: float = 0.4,
                 device=None):
        self.detector = detector or PlateDetector(
            score_threshold=score_threshold, device=device)
        self.batch_size = batch_size
        self.tracker = IOUTracker()
        self._writer = None

    def detect_batch(self, frames: List[np.ndarray]):
        """(boxes, scores, landms, valid) of frames resized to the
        detector's square input."""
        s = self.detector.image_size
        batch = np.stack([cv2.resize(f, (s, s), interpolation=cv2.INTER_LINEAR)
                          .astype(np.float32) for f in frames])
        return self.detector(batch)

    def annotate(self, frame: np.ndarray, tracks: List[Track]) -> np.ndarray:
        h, w = frame.shape[:2]
        out = frame.copy()
        for t in tracks:
            x1, y1, x2, y2 = (t.box * [w, h, w, h]).astype(int)
            cv2.rectangle(out, (x1, y1), (x2, y2), (0, 255, 0), 2)
            cv2.putText(out, f"plate#{t.track_id} {t.score:.2f}",
                        (x1, max(0, y1 - 6)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (0, 255, 0), 1)
            for p in (t.landmarks.reshape(5, 2) * [w, h]).astype(int):
                cv2.circle(out, tuple(int(v) for v in p), 2, (0, 0, 255), -1)
        return out

    def run(self, source: str, output_path: Optional[str] = None,
            max_frames: Optional[int] = None):
        """Process a video file or stream; returns [(frame index,
        tracks)]."""
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise IOError(f"cannot open video {source!r}")
        frames: List[np.ndarray] = []
        idx, results = 0, []
        try:
            while max_frames is None or idx < max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame)
                idx += 1
                if len(frames) == self.batch_size:
                    results.extend(self._process(frames, idx - len(frames),
                                                 output_path))
                    frames = []
            if frames:
                results.extend(self._process(frames, idx - len(frames),
                                             output_path))
        finally:
            cap.release()
            if self._writer is not None:
                self._writer.release()
                self._writer = None
        return results

    def _process(self, frames, start_idx, output_path):
        boxes, scores, landms, valid = self.detect_batch(frames)
        out = []
        for i, frame in enumerate(frames):
            keep = valid[i]
            tracks = self.tracker.update(boxes[i][keep], landms[i][keep],
                                         scores[i][keep])
            if output_path:
                annotated = self.annotate(frame, tracks)
                if self._writer is None:
                    h, w = annotated.shape[:2]
                    self._writer = cv2.VideoWriter(
                        output_path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                        (w, h))
                self._writer.write(annotated)
            out.append((start_idx + i, list(tracks)))
        return out

