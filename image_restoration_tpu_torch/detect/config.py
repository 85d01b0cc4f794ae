"""Detector configs — a copy of `image_restoration_tpu/detect/config.py`
(the port imports nothing of the JAX package), which mirrors the reference
Plate_Detect/Retina-License-Plate/data/config.py.

Same anchor layout: min_sizes [[16,32],[48,96],[160,224]], steps [8,16,32],
variance [0.1,0.2], 224×224 input, loc_weight 2.0.
"""

cfg_mnet = {
    "name": "mobilenet0.25",
    "min_sizes": [[16, 32], [48, 96], [160, 224]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "loc_weight": 2.0,
    "batch_size": 32,
    "epoch": 250,
    "decay1": 190,
    "decay2": 220,
    "image_size": 224,
    "in_channel": 32,
    "out_channel": 64,
}

cfg_re50 = {
    "name": "Resnet50",
    "min_sizes": [[16, 32], [48, 96], [160, 224]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "loc_weight": 2.0,
    "batch_size": 24,
    "epoch": 100,
    "decay1": 70,
    "decay2": 90,
    "image_size": 224,
    "in_channel": 256,
    "out_channel": 256,
}

cfg_re18 = {
    "name": "Resnet18",
    "min_sizes": [[16, 32], [48, 96], [160, 224]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "loc_weight": 2.0,
    "batch_size": 24,
    "epoch": 80,
    "decay1": 70,
    "decay2": 90,
    "image_size": 224,
    "in_channel": 64,
    "out_channel": 256,
}


cfg_mobilenetv3 = {
    "name": "MobilenetV3",
    "min_sizes": [[16, 32], [48, 96], [160, 224]],
    "steps": [8, 16, 32],
    "variance": [0.1, 0.2],
    "clip": False,
    "loc_weight": 2.0,
    "batch_size": 24,
    "epoch": 80,
    "decay1": 70,
    "decay2": 90,
    "image_size": 224,
    "in_channel": 64,
    "out_channel": 256,
}


def get_cfg(name: str) -> dict:
    return {"mobilenet0.25": cfg_mnet, "Resnet50": cfg_re50,
            "Resnet18": cfg_re18, "resnet18": cfg_re18,
            "resnet50": cfg_re50, "MobilenetV3": cfg_mobilenetv3,
            "mobilenetv3": cfg_mobilenetv3}[name]
