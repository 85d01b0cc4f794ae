from .from_jax import (discriminator_state_dict_from_jax,
                       qat_checkpoint_from_jax,
                       retinaface_state_dict_from_jax, state_dict_from_jax,
                       vgg_state_dict_from_jax)
from .pth import load_pth

__all__ = ["discriminator_state_dict_from_jax", "qat_checkpoint_from_jax",
           "retinaface_state_dict_from_jax", "state_dict_from_jax",
           "vgg_state_dict_from_jax", "load_pth"]
