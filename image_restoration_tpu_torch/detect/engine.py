"""Plate detection engine on the GPU.

Port of `image_restoration_tpu/detect/engine.py:27-113`: subtract the BGR
mean (104, 117, 123), RetinaFace, prior decode, then one fixed-size NMS over
the whole batch, with the landmarks gathered in the kept order. Defaults
mirror the reference TensorRT plugin (scoreThreshold 0.4, iouThreshold 0.6,
topK 200, keepTopK 20). Every stage runs on the device; only the results
come back to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..archs import build_network
from ..utils.device import resolve_device
from .box_utils import decode, decode_landm, nms
from .config import get_cfg
from .priors import prior_box

BGR_MEAN = (104.0, 117.0, 123.0)
# keys of a reference checkpoint the detector does not hold
# (convert/retinaface_import.py:45-48 of the JAX package drops the same)
_DROP_PREFIXES = ("body.fc.", "body.avg", "fc.")


class PlateDetector:
    """Callable detector over fixed-size (image_size²) BGR inputs.

    Without `ckpt_path` the weights are drawn from a generator seeded with
    `seed`. `device=None` means "cuda" and raises without a GPU.
    """

    def __init__(self, backbone: str = "Resnet18", image_size: int = 224,
                 ckpt_path: Optional[str] = None,
                 score_threshold: float = 0.4, iou_threshold: float = 0.6,
                 top_k: int = 200, keep_top_k: int = 20, dtype=None,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = get_cfg(backbone)
        self.image_size = image_size
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.top_k, self.keep_top_k = top_k, keep_top_k
        self.net = build_network(
            dict(type="RetinaFace", backbone=backbone,
                 out_channel=self.cfg["out_channel"], phase="test",
                 dtype=dtype), torch.Generator().manual_seed(seed))
        if ckpt_path:
            self.load(ckpt_path)
        self.net.to(self.device).eval().requires_grad_(False)
        self.priors = torch.from_numpy(prior_box(
            self.cfg, (image_size, image_size))).to(self.device)
        self._mean = torch.tensor(BGR_MEAN, device=self.device)

    # -------------------------------------------------------------- io

    def load(self, ckpt_path: str):
        """Load a reference `.pth` (a state_dict, optionally under
        'state_dict' and with a `module.` prefix) strictly, after dropping
        the classifier keys and `num_batches_tracked`."""
        sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        out = {}
        for k, v in sd.items():
            k = k[len("module."):] if k.startswith("module.") else k
            if k.startswith(_DROP_PREFIXES) or \
                    k.endswith("num_batches_tracked"):
                continue
            out[k] = v
        self.net.load_state_dict(out, strict=True)
        self.net.to(self.device)

    # ------------------------------------------------------------ calls

    @torch.inference_mode()
    def detect(self, images: torch.Tensor):
        """images (N, S, S, 3) float BGR in [0, 255] on the device →
        (boxes (N, K, 4), scores (N, K), landms (N, K, 10), valid (N, K)),
        K = keep_top_k, boxes and landmarks in [0, 1] coordinates."""
        return self.forward(images)

    def forward(self, images: torch.Tensor):
        """`detect` without a grad mode of its own: the graph (net, decode,
        NMS) that `scripts/export_detector.py` exports."""
        variances = self.cfg["variance"]
        loc, conf, landm = self.net(images - self._mean.to(images.dtype))
        loc, conf, landm = loc.float(), conf.float(), landm.float()
        boxes = decode(loc, self.priors, variances)
        landms = decode_landm(landm, self.priors, variances)
        kb, ks, valid, order = nms(boxes, conf[..., 1], self.iou_threshold,
                                   self.top_k, self.score_threshold)
        k = self.keep_top_k
        klm = torch.gather(landms, 1, order[:, :k, None].expand(
            -1, -1, landms.shape[-1]))
        return kb[:, :k], ks[:, :k], klm, valid[:, :k]

    def __call__(self, images_bgr255: np.ndarray):
        """Batch detect on host arrays. Returns (boxes[0..1], scores,
        landms[0..1], valid) as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(images_bgr255, np.float32))
        return tuple(o.cpu().numpy() for o in self.detect(x.to(self.device)))

    def detect_image(self, img_bgr: np.ndarray):
        """Full-size BGR uint8 image → detections in pixel coords.

        Mirrors api_plate_oto.py:220-245: resize to image_size², detect,
        scale boxes/landmarks back to the ORIGINAL image size.
        """
        import cv2
        h, w = img_bgr.shape[:2]
        inp = cv2.resize(img_bgr, (self.image_size, self.image_size),
                         interpolation=cv2.INTER_LINEAR).astype(np.float32)
        boxes, scores, landms, valid = self(inp[None])
        boxes = boxes[0] * np.asarray([w, h, w, h], np.float32)
        landms = landms[0] * np.tile([w, h], 5).astype(np.float32)
        return boxes, scores[0], landms, valid[0]
