from .from_jax import (retinaface_state_dict_from_jax, state_dict_from_jax,
                       vgg_state_dict_from_jax)
from .pth import load_pth

__all__ = ["retinaface_state_dict_from_jax", "state_dict_from_jax",
           "vgg_state_dict_from_jax", "load_pth"]
