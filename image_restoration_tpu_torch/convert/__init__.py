from .from_jax import (discriminator_state_dict_from_jax,
                       iresnet_state_dict_from_jax, qat_checkpoint_from_jax,
                       retinaface_state_dict_from_jax,
                       stacked_state_dict_from_jax, state_dict_from_jax,
                       vgg_state_dict_from_jax)
from .iresnet_import import import_iresnet
from .pth import load_pth

__all__ = ["discriminator_state_dict_from_jax", "import_iresnet",
           "iresnet_state_dict_from_jax", "qat_checkpoint_from_jax",
           "retinaface_state_dict_from_jax", "stacked_state_dict_from_jax",
           "state_dict_from_jax", "vgg_state_dict_from_jax", "load_pth"]
