"""Restoration server on the GPU — `/Vehicle_Resolution_GFPGAN/`,
`/Restore/`, `/RestoreConcat/`, `/SRx4/`.

Port of `image_restoration_tpu/serve/api.py:32-316`: the stdlib HTTP handler
in front of a `ServiceCore` that holds the product pipeline (`PlatePipeline`:
detect → crop → restore plate and car → paste back, the 6-panel montage PNG
of `/Vehicle_Resolution_GFPGAN/`), a `Restorer` and, optionally, the ×4 SR
tile engine (`EngineRestorer`, built in process with `--sr` or loaded from
the artifact directory in `IRT_SR_ENGINE`). Concurrent requests can be
coalesced by the micro-batcher (`microbatch=`, `IRT_MICROBATCH`). All device work runs on one
worker thread: PyTorch caches cuDNN's execution plans per thread, so running
on the server's thread-per-request would plan every conv anew for each
request. A route whose part is not configured answers with the reference's
500 error envelope.

    python -m image_restoration_tpu_torch.serve.api [--port 8000] \
        [--device-geometry] [--microbatch N|auto] [--detector-ckpt D.pth] \
        [--ckpt X.pth] [--sr [--sr-pth realesr.pth]]
    IRT_SR_ENGINE=engine_sr/ python -m image_restoration_tpu_torch.serve.api
"""

from __future__ import annotations

import concurrent.futures
import email
import email.policy
import json
import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _decode_request_image(body: bytes, content_type: str = "") -> np.ndarray:
    """Accept raw image bytes or multipart/form-data with a `file` field."""
    if content_type.startswith("multipart/form-data"):
        msg = email.message_from_bytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
            policy=email.policy.HTTP)
        for part in msg.iter_parts():
            payload = part.get_payload(decode=True)
            if payload:
                body = payload
                break
    arr = np.frombuffer(body, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image payload")
    return img


def _encode(img_bgr: np.ndarray, ext: str) -> bytes:
    ok, buf = cv2.imencode(ext, img_bgr)
    if not ok:
        raise RuntimeError(f"{ext} encoding failed")
    return buf.tobytes()


def _jpeg(img_bgr: np.ndarray) -> bytes:
    return _encode(img_bgr, ".jpg")


class ServiceCore:
    """Endpoint logic behind the HTTP handler, over a `PlatePipeline`, a
    `Restorer` and an optional SR engine."""

    def __init__(self, restorer=None, sr_engine=None, device_io: bool = True,
                 pipeline=None, microbatch=None,
                 microbatch_wait_ms: float = 5.0,
                 device_geometry=False):
        """restorer serves `/Restore/` and `/RestoreConcat/`; without one
        it is the pipeline's car restorer. pipeline serves
        `/Vehicle_Resolution_GFPGAN/`. Given none of restorer, pipeline and
        sr_engine, the core serves the default service: a
        `PlatePipeline(device_io=, device_geometry=)` built on the GPU.
        device_io routes restores through `Restorer.restore_batch_u8`
        (uint8 on the wire, normalization on the device, ≤1 LSB from the
        host float path); False uses the reference-exact float path.
        sr_engine: an `EngineRestorer` (or any RGB uint8 → RGB uint8
        callable) behind `/SRx4/`; without one, the artifact directory in
        the IRT_SR_ENGINE env var, if set (scripts/export_restorer.py).
        restorer may be an exported `EngineFaceRestorer`.

        microbatch (int, "auto", or None → the IRT_MICROBATCH env var, 0 by
        default) coalesces concurrent restore requests into one call of up
        to that many images, and concurrent pipeline requests into one
        `process_batch` call (chunks of at most 8); "auto" measures both
        regimes at start-up (`batching.calibrate`) and batches only where
        that wins. The batchers' calls run on the worker thread."""
        if pipeline is None and restorer is None and sr_engine is None:
            from .pipeline import PlatePipeline
            pipeline = PlatePipeline(device_io=device_io,
                                     device_geometry=device_geometry)
        self.pipeline = pipeline
        if restorer is None and pipeline is not None:
            restorer = pipeline.car_restorer
        self.restorer = restorer
        if sr_engine is None and os.environ.get("IRT_SR_ENGINE"):
            # an artifact of scripts/export_restorer.py, on the device of
            # the core's restorer (or the GPU)
            from .engine_restorer import EngineRestorer
            sr_engine = EngineRestorer(os.environ["IRT_SR_ENGINE"],
                                       device=getattr(restorer, "device",
                                                      None))
        self.sr_engine = sr_engine
        self.device_io = device_io and hasattr(self.restorer,
                                               "restore_batch_u8")
        self._worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="restore")
        self.batcher = None
        self.pipeline_batcher = None
        self.microbatch_decision = None
        if microbatch is None:
            microbatch = os.environ.get("IRT_MICROBATCH", "0") or 0
        if isinstance(microbatch, str) and \
                microbatch.strip().lower() != "auto":
            microbatch = int(microbatch.strip() or 0)
        if microbatch and self.restorer is None:
            raise ValueError("microbatch needs a restorer or a pipeline")
        if microbatch:
            restore_fn = self._on_worker(
                self.restorer.restore_batch_u8 if self.device_io
                else self.restorer.restore_batch)
        if isinstance(microbatch, str):  # "auto"
            from .batching import calibrate
            max_b = int(os.environ.get("IRT_MICROBATCH_MAX", "32") or 32)
            size = self.restorer.input_size[0] or 256
            probe = np.random.default_rng(0).random((size, size, 3)) * 255
            item = probe.astype(np.uint8) if self.device_io else \
                (probe / 255.0).astype(np.float32)
            self.microbatch_decision = calibrate(restore_fn, item,
                                                 max_batch=max_b)
            microbatch = max_b if self.microbatch_decision["recommend"] \
                else 0
            print("microbatch auto-select:",
                  "ON" if microbatch else "OFF (per-request dispatch)",
                  self.microbatch_decision, flush=True)
        if microbatch:
            from .batching import MicroBatcher
            # depth 2 overlaps gathering the next batch with the worker's
            # call on this one; IRT_MICROBATCH_DEPTH overrides
            depth = int(os.environ.get("IRT_MICROBATCH_DEPTH", "2") or 2)
            self.batcher = MicroBatcher(
                restore_fn, max_batch=microbatch,
                max_wait_ms=microbatch_wait_ms, pipeline_depth=depth)
            if self.pipeline is not None:
                # list mode (inputs of any size; the pipeline pads its own
                # chunks); depth 1: process_batch holds host-side state
                chunk = min(int(microbatch), 8)
                self.pipeline_batcher = MicroBatcher(
                    self._on_worker(lambda imgs: self.pipeline.process_batch(
                        imgs, chunk_size=chunk)),
                    max_batch=microbatch, max_wait_ms=microbatch_wait_ms,
                    stack=False, pipeline_depth=1)

    def _on_worker(self, fn):
        """fn, called on the worker thread (and waited for)."""
        return lambda *a: self._worker.submit(fn, *a).result()

    def close(self):
        """Stop the micro-batchers and the restore worker thread."""
        for b in (self.batcher, self.pipeline_batcher):
            if b is not None:
                b.stop()
        self._worker.shutdown(wait=True)

    def _restore_one(self, rgb: np.ndarray) -> np.ndarray:
        """One HWC RGB image (uint8 with device_io, float [0,1] without)
        → restored BGR uint8, computed on the worker thread, through the
        micro-batcher when it is on."""
        if self.batcher is not None:
            return self.batcher(rgb)
        if self.device_io:
            fn = lambda: self.restorer.restore_batch_u8(rgb[None])[0]  # noqa: E731
        else:
            fn = lambda: self.restorer(rgb)  # noqa: E731
        return self._worker.submit(fn).result()

    def _as_input(self, rgb_u8: np.ndarray) -> np.ndarray:
        return rgb_u8 if self.device_io else \
            rgb_u8.astype(np.float32) / 255.0

    def _size(self) -> int:
        return self.restorer.input_size[0] or 256

    def restore(self, img_bgr: np.ndarray) -> bytes:
        """Resize to the model size, restore, JPEG."""
        s = self._size()
        img = cv2.resize(img_bgr, (s, s))
        out = self._restore_one(self._as_input(img[..., ::-1]))
        return _jpeg(out)

    def restore_concat(self, img_bgr: np.ndarray) -> bytes:
        """hconcat(input, output) as JPEG."""
        s = self._size()
        img = cv2.resize(img_bgr, (s, s))
        out = self._restore_one(self._as_input(img[..., ::-1]))
        return _jpeg(cv2.hconcat([img, out]))

    def vehicle_resolution(self, img_bgr: np.ndarray) -> bytes:
        """The full pipeline (`process`, or the pipeline batcher) on the
        worker thread; the 6-panel montage as PNG."""
        if self.pipeline is None:
            raise RuntimeError("no pipeline configured: build the core with "
                               "pipeline=PlatePipeline(...)")
        if self.pipeline_batcher is not None:
            result = self.pipeline_batcher(img_bgr)
        else:
            result = self._worker.submit(self.pipeline.process,
                                         img_bgr).result()
        return _encode(result["montage"], ".png")

    def sr_x4(self, img_bgr: np.ndarray) -> bytes:
        """Tiled ×upscale SR of an image of any size through the SR engine
        (no resize: the tiler handles the size), PNG."""
        if self.sr_engine is None:
            raise RuntimeError(
                "no SR engine configured: export one with "
                "scripts/export_restorer.py and set IRT_SR_ENGINE, or build "
                "one in process (serve.api --sr)")
        rgb = np.ascontiguousarray(img_bgr[..., ::-1])
        out = self._worker.submit(self.sr_engine, rgb).result()
        return _encode(np.ascontiguousarray(out[..., ::-1]), ".png")


ROUTES = {
    "/Vehicle_Resolution_GFPGAN/": ("vehicle_resolution", "image/png"),
    "/Restore/": ("restore", "image/jpeg"),
    "/RestoreConcat/": ("restore_concat", "image/jpeg"),
    "/SRx4/": ("sr_x4", "image/png"),
}


def make_stdlib_handler(core: ServiceCore):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                route = ROUTES.get(self.path)
                if route is None:
                    self.send_error(404, f"unknown endpoint {self.path}")
                    return
                method, media = route
                img = _decode_request_image(
                    body, self.headers.get("Content-Type", ""))
                payload = getattr(core, method)(img)
                self.send_response(200)
                self.send_header("Content-Type", media)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            except Exception as exc:  # the reference's error envelope
                payload = json.dumps({"is_success": False,
                                      "msg": "Server error",
                                      "results": str(exc)}).encode()
                self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        def log_message(self, *args):
            pass

    return Handler


def make_server(core: ServiceCore, host: str = "127.0.0.1", port: int = 0):
    """A ThreadingHTTPServer for `core` (port 0 picks a free port)."""
    from http.server import ThreadingHTTPServer
    return ThreadingHTTPServer((host, port), make_stdlib_handler(core))


def run_server(core: ServiceCore, host: str = "0.0.0.0", port: int = 8000):
    server = make_server(core, host, port)
    print(f"serving on http://{host}:{server.server_address[1]} "
          "(stdlib http.server)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        core.close()


def main(argv=None):
    import argparse

    from ..infer import PRODUCTION_GFPGAN, Restorer
    from .pipeline import PlatePipeline

    ap = argparse.ArgumentParser(description="restoration serving host")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--ckpt", default=None,
                    help="reference .pth checkpoint of the plate and car "
                         "restorers (default: random weights from --seed)")
    ap.add_argument("--detector-ckpt", default=None,
                    help="reference RetinaFace .pth of the plate detector "
                         "(default: random weights from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (cuda)")
    ap.add_argument("--host-io", action="store_true",
                    help="normalize/convert on the host (reference-exact) "
                         "instead of on the device")
    ap.add_argument("--device-geometry", action="store_true",
                    help="run the pipeline's crop/mask/warp/paste/montage "
                         "on the device, one pass per chunk after the "
                         "detector")
    ap.add_argument("--microbatch", default="0",
                    help="coalesce concurrent requests into one device call "
                         "of up to N (0 = per request; 'auto' = measure "
                         "both at start-up and pick the faster)")
    ap.add_argument("--microbatch-wait-ms", type=float, default=5.0)
    ap.add_argument("--sr", action="store_true",
                    help="serve /SRx4/ with the int8 ×4 SRVGG tile engine "
                         "(kernel K2), tile 512, halo 8, 8 tiles per call")
    ap.add_argument("--sr-pth", default=None,
                    help="Real-ESRGAN SRVGGNetCompact .pth for --sr "
                         "(default: random weights from --seed)")
    a = ap.parse_args(argv)
    # the pipeline's plate and car restorers are two Restorer(PRODUCTION_
    # GFPGAN), as PlatePipeline() builds them; /Restore/ uses the car one
    plate, car = (Restorer(PRODUCTION_GFPGAN, a.ckpt, device=a.device,
                           seed=a.seed) for _ in range(2))
    pipeline = PlatePipeline(plate_restorer=plate, car_restorer=car,
                             detector_ckpt=a.detector_ckpt,
                             device_io=not a.host_io,
                             device_geometry=a.device_geometry,
                             device=a.device, seed=a.seed)
    sr_engine = None
    if a.sr:
        from .engine_restorer import EngineRestorer
        sr_engine = EngineRestorer.build(pth=a.sr_pth, seed=a.seed,
                                         device=a.device)
    run_server(ServiceCore(car, sr_engine, device_io=not a.host_io,
                           pipeline=pipeline, microbatch=a.microbatch,
                           microbatch_wait_ms=a.microbatch_wait_ms),
               a.host, a.port)


if __name__ == "__main__":
    main()
