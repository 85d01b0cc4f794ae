"""Name → class registries with decorator registration.

A copy of `image_restoration_tpu/utils/registry.py` (the port imports
nothing of the JAX package): networks, datasets, losses, metrics and
trainers are dispatched from the ``type:`` key of a config dict under the
same names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


class Registry:
    """A string-keyed registry mapping names to callables/classes."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any, suffix: str | None = None) -> None:
        if suffix is not None:
            name = f"{name}_{suffix}"
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry")
        self._obj_map[name] = obj

    def register(self, obj: Any = None, suffix: str | None = None) -> Callable:
        """Use as ``@REGISTRY.register()`` or ``REGISTRY.register(cls)``."""
        if obj is None:
            def deco(func_or_class: Any) -> Any:
                self._do_register(func_or_class.__name__, func_or_class, suffix)
                return func_or_class
            return deco
        self._do_register(obj.__name__, obj, suffix)
        return obj

    def get(self, name: str, suffix: str = "ir_tpu") -> Any:
        ret = self._obj_map.get(name)
        if ret is None:
            ret = self._obj_map.get(f"{name}_{suffix}")
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry. "
                f"Known: {sorted(self._obj_map)}")
        return ret

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
MODEL_REGISTRY = Registry("model")
