"""Plate detector: configs, priors, box decoding and NMS, and the
`PlateDetector` engine (RetinaFace on the GPU)."""

from .box_utils import decode, decode_landm, jaccard, nms, py_cpu_nms
from .config import cfg_mnet, cfg_mobilenetv3, cfg_re18, cfg_re50, get_cfg
from .engine import PlateDetector
from .priors import prior_box

__all__ = ["decode", "decode_landm", "jaccard", "nms", "py_cpu_nms",
           "cfg_mnet", "cfg_mobilenetv3", "cfg_re18", "cfg_re50", "get_cfg",
           "PlateDetector", "prior_box"]
