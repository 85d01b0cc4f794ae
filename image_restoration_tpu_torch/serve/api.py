"""Restoration server on the GPU — `/Restore/`, `/RestoreConcat/`, `/SRx4/`.

Port of `image_restoration_tpu/serve/api.py:32-290` for the restore and SR
endpoints: the stdlib HTTP handler in front of a `ServiceCore` that holds one
`Restorer` and, optionally, the ×4 SR tile engine (`EngineRestorer`).
`/Vehicle_Resolution_GFPGAN/` (the detect → crop → restore → paste pipeline)
is not ported yet; it answers with the reference's 500 error envelope, as
`/SRx4/` does when no engine is set. Requests run one by one (the
micro-batcher is not ported yet), all on one worker thread: PyTorch caches
cuDNN's execution plans per thread, so running on the server's
thread-per-request would plan every conv anew for each request.

    python -m image_restoration_tpu_torch.serve.api [--port 8000] \
        [--ckpt X.pth] [--sr [--sr-pth realesr.pth]]
"""

from __future__ import annotations

import concurrent.futures
import email
import email.policy
import json

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
    """Endpoint logic behind the HTTP handler, over one `Restorer` and an
    optional SR engine."""

    def __init__(self, restorer, sr_engine=None, device_io: bool = True):
        """device_io routes restores through `Restorer.restore_batch_u8`
        (uint8 on the wire, normalization on the device, ≤1 LSB from the
        host float path); False uses the reference-exact float path.
        sr_engine: an `EngineRestorer` (or any RGB uint8 → RGB uint8
        callable) behind `/SRx4/`."""
        self.restorer = restorer
        self.sr_engine = sr_engine
        self.device_io = device_io and hasattr(restorer, "restore_batch_u8")
        self._worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="restore")

    def close(self):
        """Stop the restore worker thread."""
        self._worker.shutdown(wait=True)

    def _restore_one(self, rgb: np.ndarray) -> np.ndarray:
        """One HWC RGB image (uint8 with device_io, float [0,1] without)
        → restored BGR uint8, computed on the worker thread."""
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
        raise NotImplementedError(
            "/Vehicle_Resolution_GFPGAN/ is not ported yet (needs the plate "
            "detector and the pipeline)")

    def sr_x4(self, img_bgr: np.ndarray) -> bytes:
        """Tiled ×upscale SR of an image of any size through the SR engine
        (no resize: the tiler handles the size), PNG."""
        if self.sr_engine is None:
            raise RuntimeError(
                "no SR engine configured: build one with "
                "EngineRestorer.build() (serve.api --sr)")
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

    ap = argparse.ArgumentParser(description="restoration serving host")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--ckpt", default=None,
                    help="reference .pth checkpoint (default: random "
                         "weights from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (cuda)")
    ap.add_argument("--host-io", action="store_true",
                    help="normalize/convert on the host (reference-exact) "
                         "instead of on the device")
    ap.add_argument("--sr", action="store_true",
                    help="serve /SRx4/ with the int8 ×4 SRVGG tile engine "
                         "(kernel K2), tile 512, halo 8, 8 tiles per call")
    ap.add_argument("--sr-pth", default=None,
                    help="Real-ESRGAN SRVGGNetCompact .pth for --sr "
                         "(default: random weights from --seed)")
    a = ap.parse_args(argv)
    restorer = Restorer(PRODUCTION_GFPGAN, a.ckpt, device=a.device,
                        seed=a.seed)
    sr_engine = None
    if a.sr:
        from .engine_restorer import EngineRestorer
        sr_engine = EngineRestorer.build(pth=a.sr_pth, seed=a.seed,
                                         device=a.device)
    run_server(ServiceCore(restorer, sr_engine, device_io=not a.host_io),
               a.host, a.port)


if __name__ == "__main__":
    main()
