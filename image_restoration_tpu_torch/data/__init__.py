"""Data layer: degradation synthesis on the device, loading on the host."""

from copy import deepcopy

from ..utils.registry import DATASET_REGISTRY
from .loader import build_dataloader, DataLoader, EnlargedSampler  # noqa: F401


def build_dataset(opt):
    """Instantiate a dataset from a config dict with a `type:` key."""
    from . import datasets  # noqa: F401  (registration)
    opt = deepcopy(opt)
    dataset_type = opt.pop("type")
    if dataset_type not in DATASET_REGISTRY:
        from . import video_datasets  # noqa: F401  (registered when asked)
    return DATASET_REGISTRY.get(dataset_type)(opt)
