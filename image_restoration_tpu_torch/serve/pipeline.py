"""End-to-end product pipeline on the GPU: detect → crop/mask/pad → restore
plate + car → perspective paste-back → montage.

Port of `image_restoration_tpu/serve/pipeline.py:36-541`, which mirrors the
reference Car_Plate-Restoration/api_plate_oto.py:
  * detector landmarks scaled to the 256² canvas (:238-245);
  * crop = boundingRect of the corner landmarks [p1, p2, p5, p4], polygon
    mask, masked composite (black background), aspect-preserving pad to 256²
    (:264-297);
  * the plate restorer is fed WITHOUT a BGR→RGB swap, the car restorer WITH
    one, both ±0.5-normalized, outputs in (−1, 1) (:349-401);
  * perspective warp of the restored plate back onto the restored car with a
    polygon-mask paste (:304-320, :455-466), and the 6-panel montage
    (:449-466).

Threads: PyTorch caches cuDNN's plans per thread, so every device call runs
on the thread that calls `process`/`process_batch`; their thread pool runs
only cv2/numpy stages. An exported fused-geometry engine (`geo_engine=`,
`EngineGeoPipeline`) serves everything after the detector from its
artifact.
"""

from __future__ import annotations

import base64
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..detect.engine import PlateDetector
from ..infer import PRODUCTION_GFPGAN, Restorer
from ..ops.geometry import (bbox_of_quad, crop_resize, det3x3,
                            homography_square_to_quad, pad_resize, quad_mask,
                            quad_mask_aa, warp_perspective)

log = logging.getLogger(__name__)


def image_to_base64(img_bgr: np.ndarray) -> str:
    """utils.py:image_to_base64 parity."""
    _, buf = cv2.imencode(".jpg", img_bgr)
    return base64.b64encode(buf.tobytes()).decode("utf-8")


def base64_to_image(data: str) -> np.ndarray:
    """utils.py:base64_to_image parity."""
    arr = np.frombuffer(base64.b64decode(data), np.uint8)
    return cv2.imdecode(arr, cv2.IMREAD_COLOR)


def resize_with_padding(img_bgr: np.ndarray, expected=(256, 256),
                        fill: int = 0) -> np.ndarray:
    """PIL thumbnail+expand equivalent (api_plate_oto.py:186-194)."""
    h, w = img_bgr.shape[:2]
    scale = min(expected[0] / w, expected[1] / h, 1.0)
    nw, nh = max(1, int(w * scale)), max(1, int(h * scale))
    resized = cv2.resize(img_bgr, (nw, nh))
    canvas = np.full((expected[1], expected[0], 3), fill, np.uint8)
    x0 = (expected[0] - nw) // 2
    y0 = (expected[1] - nh) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = resized
    return canvas


def build_geo_fused(plate_restorer, car_restorer, target: int):
    """Everything after the detector as one eager callable on the device:
    masked boundingRect crop+resize → both restores → perspective
    warp-back → paste → 6-panel montage (the host stages of ref
    api_plate_oto.py:264-320,449-466, through ops/geometry.py).

    fused(canvas_u8 (N, T, T, 3) BGR, quads (N, 4, 2) float32), both on the
    restorers' device → (montage_u8 (N, T, 6T, 3), masked_canvas_u8). It
    sets no grad mode, so `scripts/export_gfpgan.py --with-geometry` can
    export it; call it under `torch.inference_mode()`. Each restore runs in
    its Restorer's quant mode."""
    t = target
    plate, car = plate_restorer, car_restorer
    same = plate is car
    for name, r in (("plate", plate), ("car", car)):
        # the fused graph feeds the net at the canvas size directly; a
        # restorer whose serving surface would resize (input_size !=
        # target) or shard (data_parallel) would diverge from the host
        # path here, so refuse instead
        isz = getattr(r, "input_size", (None, None))
        if isz[0] is not None and tuple(isz) != (t, t):
            raise ValueError(
                f"device_geometry: {name} restorer input_size {isz} != "
                f"pipeline target ({t}, {t}); the fused graph does not "
                "re-implement the resize step")
        if getattr(r, "data_parallel", 0) and r.data_parallel > 1:
            raise ValueError(
                f"device_geometry does not support data_parallel "
                f"restorers ({name} has data_parallel={r.data_parallel})")
    dev = plate.device
    mean_p, std_p = (torch.as_tensor(plate.mean, device=dev),
                     torch.as_tensor(plate.std, device=dev))
    mean_c, std_c = (torch.as_tensor(car.mean, device=dev),
                     torch.as_tensor(car.std, device=dev))
    lo_p, hi_p = plate.out_min_max
    lo_c, hi_c = car.out_min_max
    eye = torch.eye(3, device=dev)

    def fused(canvas_u8: torch.Tensor, quads: torch.Tensor):
        n = canvas_u8.shape[0]
        canvas_f = canvas_u8.float()
        # crop composite: the drawContours-AA twin (keeps the ~1.5 px ink
        # band); paste: the fillPoly twin (hard polygon), as the host path
        masked = canvas_f * quad_mask_aa(quads, (t, t))[..., None]
        mask = quad_mask(quads, (t, t))
        bbox = bbox_of_quad(quads, (t, t))
        crop_rs = crop_resize(masked, bbox, (t, t))   # BGR f32 0..255
        crop_pad = pad_resize(masked, bbox, (t, t))
        # plate input: NO channel swap (ref :349-374, the net saw BGR);
        # car input: BGR→RGB (ref :376-401)
        plate_in = (crop_rs / 255.0 - mean_p) / std_p
        car_in = (canvas_f.flip(-1) / 255.0 - mean_c) / std_c
        if same:
            out = plate.forward(torch.cat([plate_in, car_in]))
            out_p, out_c = out[:n], out[n:]
        else:
            out_p, out_c = plate.forward(plate_in), car.forward(car_in)
        yp = torch.clamp(out_p.float(), lo_p, hi_p) - lo_p
        plate_f = yp / (hi_p - lo_p) * 255.0        # stays in net order
        yc = torch.clamp(out_c.float(), lo_c, hi_c) - lo_c
        car_f = (yc / (hi_c - lo_c)).flip(-1) * 255.0   # → BGR

        m = homography_square_to_quad(float(t), quads)
        # a degenerate quad gives black warped content (the host path's
        # float64 garbage matrix lands nowhere too). Two shapes: a repeated
        # q2/q3 corner makes m non-finite, a repeated q0/q1 corner leaves m
        # finite but singular (inv3x3 would poison the warp with NaN)
        m_ok = torch.isfinite(m).all(-1).all(-1) & (det3x3(m).abs() > 1e-8)
        m_safe = torch.where(m_ok[:, None, None], m, eye)
        # one warp over 6 channels: both warps sample the same homography
        both = warp_perspective(torch.cat([crop_rs, plate_f], -1), m_safe)
        both = both * m_ok.to(both.dtype)[:, None, None, None]
        transform, plate_warp = both[..., :3], both[..., 3:]
        pasted = torch.where((mask > 0)[..., None], plate_warp, car_f)
        montage = torch.cat([canvas_f, plate_f, car_f, crop_pad, transform,
                             pasted], dim=2)
        montage_u8 = torch.round(torch.clamp(montage, 0.0, 255.0)).to(
            torch.uint8)
        return montage_u8, torch.round(masked).to(torch.uint8)

    return fused


class PlatePipeline:
    """Detector + plate restorer + car restorer, all on one GPU."""

    TARGET = 256

    def __init__(self, detector: Optional[PlateDetector] = None,
                 plate_restorer: Optional[Restorer] = None,
                 car_restorer: Optional[Restorer] = None,
                 detector_ckpt: Optional[str] = None,
                 plate_ckpt: Optional[str] = None,
                 car_ckpt: Optional[str] = None, dtype=None,
                 device_io: bool = True, device_geometry=False,
                 geo_engine=None, device=None, seed: int = 0):
        """device_io routes the restores through Restorer.restore_batch_u8
        (uint8 on the wire both ways, normalization on the device; ≤1 LSB
        from the host float path); False normalizes on the host, as the
        reference does. Duck-typed restorers without the u8 entry point
        take the host path.

        device_geometry=True runs every post-detector stage (polygon mask,
        boundingRect crop+resize, both restores, the warp-back, paste and
        montage) as one eager device pass per chunk (`build_geo_fused`), so
        the host does only JPEG decode and the first resizes. It equals the
        host path up to cv2's fixed-point bilinear rounding (~1 LSB) and
        polygon-edge rasterization (≤1-px band). "auto" times both paths on
        the first process_batch call and keeps the faster.

        Missing parts are built on `device` (None → "cuda", raising without
        a GPU): the default Resnet18 detector at 224² and two
        `Restorer(PRODUCTION_GFPGAN)`, with weights from `seed` unless a
        checkpoint is given.

        geo_engine: an exported fused-geometry engine (`EngineGeoPipeline`,
        from `scripts/export_gfpgan.py --with-geometry`) that serves the
        same post-detector graph from its artifact; it implies
        device_geometry. The engine's own weights serve every restore, so
        restorers or checkpoints given beside it are unused (a warning
        says so) and none is built for it."""
        if geo_engine is not None:
            tgt = getattr(geo_engine, "target", None)
            if tgt is not None and tgt != self.TARGET:
                raise ValueError(
                    f"geo_engine target {tgt} != pipeline TARGET "
                    f"{self.TARGET} (exported at a different canvas size)")
            if any(a is not None for a in (plate_restorer, car_restorer,
                                           plate_ckpt, car_ckpt)):
                log.warning("PlatePipeline: geo_engine is set; every restore "
                            "is served from the engine's own weights, the "
                            "restorer and checkpoint arguments are unused")
        self.detector = detector or PlateDetector(
            ckpt_path=detector_ckpt, dtype=dtype, device=device, seed=seed)
        # the reference's TorchScript plate model is GFPGANv1OCR at the
        # production config (SURVEY §7); with a geo_engine and no restorers
        # given, none is built (the engine carries the weights)
        if geo_engine is not None and plate_restorer is None and \
                car_restorer is None:
            self.plate_restorer = self.car_restorer = None
        else:
            self.plate_restorer = plate_restorer or Restorer(
                PRODUCTION_GFPGAN, plate_ckpt, dtype=dtype, device=device,
                seed=seed)
            self.car_restorer = car_restorer or Restorer(
                PRODUCTION_GFPGAN, car_ckpt, dtype=dtype, device=device,
                seed=seed)
        self.device_io = (device_io
                          and hasattr(self.plate_restorer, "restore_batch_u8")
                          and hasattr(self.car_restorer, "restore_batch_u8"))
        self._geo_engine = geo_engine
        geo_capable = geo_engine is not None or all(
            hasattr(r, "forward") and hasattr(r, "device")
            for r in (self.plate_restorer, self.car_restorer))
        # "auto": measure both paths on the first real batch and keep the
        # faster; which wins depends on batch size, host load and the
        # geometry-op mix, so neither is hardcoded
        self._geo_auto_pending = (device_geometry == "auto" and geo_capable
                                  and geo_engine is None)
        self.device_geometry = geo_engine is not None or (
            device_geometry is True and geo_capable)
        self.geo_auto_ms_per_image = None
        self._geo_fused = None

    def _dispatch(self, restorer, rgb_u8_batch: np.ndarray) -> np.ndarray:
        """(N,H,W,3) uint8 RGB batch → (N,H',W',3) BGR uint8 via the
        selected IO path — the single place the device_io choice lives."""
        if self.device_io:
            return restorer.restore_batch_u8(rgb_u8_batch)
        return restorer.restore_batch(
            rgb_u8_batch.astype(np.float32) / 255.0)

    # --------------------------------------------- device geometry path

    def _geo_batch(self, canvases: np.ndarray, quads: np.ndarray):
        """The fused device-geometry pass (or the exported engine) on a
        canvas batch; returns (montage_u8, masked_u8) as numpy."""
        if self._geo_engine is not None:
            return self._geo_engine(canvases, np.asarray(quads, np.float32))
        if self._geo_fused is None:
            self._geo_fused = build_geo_fused(
                self.plate_restorer, self.car_restorer, self.TARGET)
        dev = self.plate_restorer.device
        with torch.inference_mode():
            mont, masked = self._geo_fused(
                torch.from_numpy(np.ascontiguousarray(canvases)).to(dev),
                torch.from_numpy(np.asarray(quads, np.float32)).to(dev))
            return mont.cpu().numpy(), masked.cpu().numpy()

    def _geo_result(self, montage: np.ndarray, masked: np.ndarray,
                    canvas, quad, score, ok) -> Dict[str, np.ndarray]:
        """process()-shaped dict from one montage row (panels are views
        into the montage) + the raw crop from the masked canvas."""
        t = self.TARGET
        panel = lambda i: montage[:, i * t:(i + 1) * t]  # noqa: E731
        x, y, w, h = cv2.boundingRect(quad)
        x, y = max(x, 0), max(y, 0)
        w, h = max(w, 1), max(h, 1)
        return {
            "input": canvas,
            "quad": quad,
            "score": score,
            "detected": ok,
            "crop": masked[y:y + h, x:x + w],
            "crop_padded": panel(3),
            "plate_restored": panel(1),
            "car_restored": panel(2),
            "transform": panel(4),
            "pasted": panel(5),
            "montage": montage,
        }

    # ----------------------------------------------------------- helpers

    def _quads(self, landms, scores, valid):
        """Top detection of each image → its corner quad [p1, p2, p5, p4]
        on the TARGET² canvas (clipped), score and validity."""
        t = self.TARGET
        out = []
        for i in range(landms.shape[0]):
            p1, p2, _, p4, p5 = (landms[i, 0].reshape(5, 2) * t).astype(
                np.int32)
            out.append((np.clip(np.array([p1, p2, p5, p4], np.int32), 0,
                                t - 1), float(scores[i, 0]),
                        bool(valid[i, 0])))
        return out

    def _detect_quad(self, img_bgr: np.ndarray):
        """The top detection on one image → (quad, score, valid)."""
        inp = cv2.resize(img_bgr.astype(np.float32),
                         (self.detector.image_size,
                          self.detector.image_size),
                         interpolation=cv2.INTER_LINEAR)
        _, scores, landms, valid = self.detector(inp[None])
        return self._quads(landms, scores, valid)[0]

    def _crop_plate(self, canvas_bgr: np.ndarray, quad: np.ndarray):
        """boundingRect crop + polygon mask composite (ref :264-297)."""
        x, y, w, h = cv2.boundingRect(quad)
        x, y = max(x, 0), max(y, 0)
        w, h = max(w, 1), max(h, 1)
        croped = canvas_bgr[y:y + h, x:x + w].copy()
        pts = quad - quad.min(axis=0)
        mask = np.zeros(croped.shape[:2], np.uint8)
        cv2.drawContours(mask, [pts], -1, (255, 255, 255), -1, cv2.LINE_AA)
        return cv2.bitwise_and(croped, croped, mask=mask)

    def _restore_plate(self, crop_bgr: np.ndarray) -> np.ndarray:
        """ref restoration_plate (:349-374): NO channel swap, ±0.5 norm."""
        out = self._dispatch(self.plate_restorer, crop_bgr[None])[0]
        return out[..., ::-1]          # undo its RGB→BGR: the net saw BGR

    def _restore_car(self, img_bgr: np.ndarray) -> np.ndarray:
        """ref restoration_car (:376-401): BGR→RGB swap + ±0.5 norm."""
        img = cv2.resize(img_bgr, (self.TARGET, self.TARGET))
        return self._dispatch(self.car_restorer,
                              np.ascontiguousarray(img[..., ::-1])[None])[0]

    def _finish_one(self, canvas, quad, score, ok, crop, plate_restored,
                    car_restored) -> Dict[str, np.ndarray]:
        """Host post stage: perspective warp, paste-back, montage
        (ref :304-320, :449-466). OpenCV/numpy only, no device work."""
        t = self.TARGET
        crop_padded = resize_with_padding(crop, (t, t))
        # perspective: restored crop (T²) → original quad (ref :304-320)
        pst1 = np.float32([[0, 0], [t, 0], [t, t], [0, t]])
        matrix = cv2.getPerspectiveTransform(pst1, quad.astype(np.float32))
        crop_resized = cv2.resize(crop, (t, t)) if crop.size else \
            np.zeros((t, t, 3), np.uint8)
        transform = cv2.warpPerspective(crop_resized, matrix, (t, t))
        # paste the warped restored plate into the restored car
        # (ref :455-466): copy where the polygon mask is set
        plate_warp = cv2.warpPerspective(plate_restored, matrix, (t, t))
        mask = np.zeros((t, t), np.uint8)
        cv2.fillPoly(mask, [quad], 255)
        pasted = cv2.copyTo(plate_warp, mask, car_restored.copy())
        montage = cv2.hconcat([canvas, plate_restored, car_restored,
                               crop_padded, transform, pasted])
        return {
            "input": canvas,
            "quad": quad,
            "score": score,
            "detected": ok,
            "crop": crop,
            "crop_padded": crop_padded,
            "plate_restored": plate_restored,
            "car_restored": car_restored,
            "transform": transform,
            "pasted": pasted,
            "montage": montage,
        }

    def _autoselect_geometry(self, chunk, chunk_size: int):
        """device_geometry="auto": wall-time one warmed chunk through the
        host-cv2 path and the fused device path, keep the faster. Runs once,
        on the first process_batch call of more than one image; process()
        stays on the host path until then."""
        self._geo_auto_pending = False
        times = {}
        for flag in (False, True):
            self.device_geometry = flag
            self.process_batch(chunk, chunk_size)       # warm-up
            t0 = time.perf_counter()
            self.process_batch(chunk, chunk_size)
            times["device" if flag else "host"] = \
                (time.perf_counter() - t0) / len(chunk)
        self.device_geometry = times["device"] <= times["host"]
        self.geo_auto_ms_per_image = {k: v * 1e3 for k, v in times.items()}
        log.info("PlatePipeline geometry auto-select (bs=%d): host %.3f "
                 "ms/img, device %.3f ms/img -> %s path", len(chunk),
                 self.geo_auto_ms_per_image["host"],
                 self.geo_auto_ms_per_image["device"],
                 "device" if self.device_geometry else "host")

    # -------------------------------------------------------------- main

    def process(self, img_bgr: np.ndarray) -> Dict[str, np.ndarray]:
        """Full pipeline on one BGR uint8 image. Returns every stage image
        (the montage is the reference's 6-panel output)."""
        t = self.TARGET
        canvas = cv2.resize(img_bgr, (t, t), interpolation=cv2.INTER_LINEAR)
        quad, score, ok = self._detect_quad(img_bgr)
        quad = np.clip(quad, 0, t - 1)
        if self.device_geometry:
            mont, masked = self._geo_batch(canvas[None], quad[None])
            return self._geo_result(mont[0], masked[0], canvas, quad,
                                    score, ok)
        crop = self._crop_plate(canvas, quad)
        plate_restored = self._restore_plate(
            cv2.resize(crop, (t, t)) if crop.size else
            np.zeros((t, t, 3), np.uint8))
        car_restored = self._restore_car(img_bgr)
        return self._finish_one(canvas, quad, score, ok, crop,
                                plate_restored, car_restored)

    def process_batch(self, imgs, chunk_size: int = 8,
                      host_workers: int = 4):
        """Batched and pipelined pipeline over a list of BGR uint8 images.

        Runs the detector at bs = chunk_size, the two restores as batched
        calls (one 2N call when plate and car share a Restorer), the host
        stages thread-parallel across the chunk, and chunk i's paste/montage
        overlapped with chunk i+1's device work. A ragged final chunk is
        padded to chunk_size (the extra rows are discarded), so every stage
        sees one batch shape. Device calls stay on the calling thread.

        Returns a list of `process`-shaped dicts in input order.
        """
        from concurrent.futures import ThreadPoolExecutor

        if not len(imgs):
            return []
        if self._geo_auto_pending and len(imgs) > 1:
            self._autoselect_geometry(list(imgs[:chunk_size]), chunk_size)
        t = self.TARGET
        ds = self.detector.image_size
        fused = self.plate_restorer is self.car_restorer
        results: list = [None] * len(imgs)
        post: list = []  # (result index, future)

        def pre(img):
            canvas = cv2.resize(img, (t, t), interpolation=cv2.INTER_LINEAR)
            det_in = cv2.resize(img.astype(np.float32), (ds, ds),
                                interpolation=cv2.INTER_LINEAR)
            if self.device_geometry:
                # the fused pass builds the car input from the canvas
                return canvas, det_in, None
            # _restore_car input: BGR→RGB swap (ref :376-401), uint8
            return canvas, det_in, cv2.resize(img, (t, t))[..., ::-1]

        def mid(canvas, quad):
            crop = self._crop_plate(canvas, quad)
            # _restore_plate input: NO channel swap (ref :349-374)
            plate_in = (cv2.resize(crop, (t, t)) if crop.size else
                        np.zeros((t, t, 3), np.uint8))
            return crop, plate_in

        with ThreadPoolExecutor(max_workers=host_workers) as pool:
            for base in range(0, len(imgs), chunk_size):
                chunk = list(imgs[base:base + chunk_size])
                n_real = len(chunk)
                chunk += [chunk[-1]] * (chunk_size - n_real)

                canvases, det_ins, car_ins = zip(*pool.map(pre, chunk))
                _, scores, landms, valid = self.detector(np.stack(det_ins))
                quads, scs, oks = zip(*self._quads(landms, scores, valid))

                if self.device_geometry:
                    monts, maskeds = self._geo_batch(np.stack(canvases),
                                                     np.stack(quads))
                    for i in range(n_real):
                        results[base + i] = self._geo_result(
                            monts[i], maskeds[i], canvases[i], quads[i],
                            scs[i], oks[i])
                    continue

                mids = list(pool.map(mid, canvases, quads))
                crops = [m[0] for m in mids]
                plate_ins = np.stack([m[1] for m in mids])
                cars = np.stack(car_ins)
                if fused:
                    both = self._dispatch(self.plate_restorer,
                                          np.concatenate([plate_ins, cars]))
                    plate_outs = both[:len(chunk)][..., ::-1]
                    car_outs = both[len(chunk):]
                else:
                    plate_outs = self._dispatch(self.plate_restorer,
                                                plate_ins)[..., ::-1]
                    car_outs = self._dispatch(self.car_restorer, cars)

                for i in range(n_real):
                    post.append((base + i, pool.submit(
                        self._finish_one, canvases[i], quads[i], scs[i],
                        oks[i], crops[i], plate_outs[i], car_outs[i])))
            for idx, fut in post:
                results[idx] = fut.result()
        return results
