"""Detect → align → restore → paste-back helper for plates (or faces).

Port of `image_restoration_tpu/utils/face_util.py` `RestorationHelper`
:22 (the role of BasicSR's dlib FaceRestorationHelper): each detection's
five landmarks are fitted onto a fixed five-point template by
`cv2.estimateAffinePartial2D` (LMEDS), the region is warped to a
face_size² crop, restored, and warped back with the inverse affine under
an eroded and blurred mask. The default detector is the port's
`PlateDetector` (`detect/engine.py` `detect_image`); any object with the
same `detect_image` can take its place.
"""

from __future__ import annotations

from typing import List

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class RestorationHelper:
    """Detect → affine-align crops → restore → inverse-paste."""

    def __init__(self, detector=None, upscale_factor: int = 1,
                 face_size: int = 256, device=None):
        if detector is None:
            from ..detect.engine import PlateDetector
            detector = PlateDetector(device=device)
        self.detector = detector
        self.upscale_factor = upscale_factor
        self.face_size = face_size
        self.template = np.asarray(
            [[0.15, 0.25], [0.85, 0.25], [0.5, 0.5], [0.15, 0.75],
             [0.85, 0.75]], np.float32) * face_size
        self.reset()

    def reset(self):
        self.landmarks: List[np.ndarray] = []
        self.affine_matrices: List[np.ndarray] = []
        self.cropped_faces: List[np.ndarray] = []
        self.restored_faces: List[np.ndarray] = []
        self.input_img = None

    def detect_landmarks(self, img_bgr: np.ndarray) -> int:
        """Keep the 5 landmark points of each valid detection."""
        self.input_img = img_bgr
        boxes, scores, landms, valid = self.detector.detect_image(img_bgr)
        for i in range(len(scores)):
            if valid[i]:
                self.landmarks.append(np.asarray(landms[i]).reshape(5, 2))
        return len(self.landmarks)

    def warp_crop_faces(self) -> List[np.ndarray]:
        """Affine-align each detected region to the template crop."""
        for lm in self.landmarks:
            m, _ = cv2.estimateAffinePartial2D(lm.astype(np.float32),
                                               self.template,
                                               method=cv2.LMEDS)
            crop = cv2.warpAffine(self.input_img, m,
                                  (self.face_size, self.face_size))
            self.affine_matrices.append(m)
            self.cropped_faces.append(crop)
        return self.cropped_faces

    def add_restored_face(self, face_bgr: np.ndarray):
        self.restored_faces.append(face_bgr)

    def restore_faces(self, restorer) -> List[np.ndarray]:
        """Restore every crop, one `restorer` call each (a `Restorer`: RGB
        float [0, 1] in, BGR uint8 out), and keep the results."""
        for crop in self.cropped_faces:
            rgb = crop[..., ::-1].astype(np.float32) / 255.0
            self.add_restored_face(restorer(rgb))
        return self.restored_faces

    def paste_faces_to_input_image(self) -> np.ndarray:
        """Inverse-affine paste with eroded, blurred masks."""
        h, w = self.input_img.shape[:2]
        up = self.upscale_factor
        out = cv2.resize(self.input_img, (w * up, h * up))
        for face, m in zip(self.restored_faces, self.affine_matrices):
            inv = cv2.invertAffineTransform(m * up)
            warped = cv2.warpAffine(face, inv, (w * up, h * up))
            mask = np.ones(face.shape[:2], np.float32)
            mask = cv2.warpAffine(mask, inv, (w * up, h * up))
            mask = cv2.erode(mask, np.ones((3, 3), np.uint8))
            mask = cv2.GaussianBlur(mask, (11, 11), 0)[..., None]
            out = (warped * mask + out * (1 - mask)).astype(np.uint8)
        return out
