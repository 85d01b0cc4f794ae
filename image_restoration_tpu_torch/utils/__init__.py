from .device import resolve_device
from .registry import ARCH_REGISTRY

__all__ = ["resolve_device", "ARCH_REGISTRY"]
