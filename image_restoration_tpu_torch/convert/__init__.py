from .from_jax import state_dict_from_jax
from .pth import load_pth

__all__ = ["state_dict_from_jax", "load_pth"]
