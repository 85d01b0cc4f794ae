"""Test pipeline: every `datasets.test_*` of a YAML config through the
model's validation.

Port of `image_restoration_tpu/test.py`:

    python -m image_restoration_tpu_torch.test \\
        -opt configs/test_esrgan_x4.yml [--force_yml path:pretrain_network_g=net_g.pth]

The model runs on the card (it raises without a GPU); `test_pipeline(...,
device="cpu")` runs the plain PyTorch path on the CPU. For each test set
it restores every image with the EMA (or only) G, scores it with the
config's `val.metrics` where the set has a GT, and writes the restored
images under `results/<name>/visualization` when `val.save_img` is set
(the default). A set whose dataset has a degradation pipeline is degraded
on the device first. Returns {set name: {metric: mean}}.
"""

from __future__ import annotations

import time
from os import path as osp

from .data import build_dataloader, build_dataset
from .models import build_model
from .utils.logger import get_env_info, get_root_logger
from .utils.misc import make_exp_dirs
from .utils.options import dict2str, parse_options


def test_pipeline(root_path: str | None = None, argv=None, device=None):
    opt, _ = parse_options(root_path, is_train=False, argv=argv)
    make_exp_dirs(opt)
    log_file = osp.join(opt["path"]["log"],
                        f"test_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    model = build_model(opt, device=device)
    results = {}
    for _, dataset_opt in sorted(opt["datasets"].items()):
        dataset = build_dataset(dataset_opt)
        loader = build_dataloader(dataset, dataset_opt)
        name = dataset_opt["name"]
        logger.info(f"Testing {name} ({len(dataset)} images)...")
        pipeline = dataset.device_pipeline()
        if pipeline is not None:
            model.set_degradation_pipeline(pipeline)
        results[name] = model.validation(
            loader, current_iter=opt["name"], tb_logger=None,
            save_img=opt.get("val", {}).get("save_img", True))
    return results


if __name__ == "__main__":
    test_pipeline(osp.abspath(osp.join(__file__, osp.pardir, osp.pardir)))
