from .from_jax import (discriminator_state_dict_from_jax,
                       hifacegan_state_dict_from_jax,
                       inception_state_dict_from_jax,
                       iresnet_state_dict_from_jax, qat_checkpoint_from_jax,
                       retinaface_state_dict_from_jax,
                       stacked_state_dict_from_jax, state_dict_from_jax,
                       vgg_state_dict_from_jax)
from .dfdnet_import import (dfdnet_reference_state_dict, dfdnet_state_dict,
                            load_dfdnet, load_dfdnet_dict)
from .hifacegan_import import fold_spectral_norm, load_hifacegan
from .iresnet_import import import_iresnet
from .pth import load_pth
from .resnet_import import load_torchvision_resnet

__all__ = ["dfdnet_state_dict", "discriminator_state_dict_from_jax",
           "fold_spectral_norm", "load_dfdnet", "load_dfdnet_dict",
           "dfdnet_reference_state_dict",
           "hifacegan_state_dict_from_jax", "import_iresnet",
           "inception_state_dict_from_jax",
           "load_hifacegan", "load_torchvision_resnet",
           "iresnet_state_dict_from_jax", "qat_checkpoint_from_jax",
           "retinaface_state_dict_from_jax", "stacked_state_dict_from_jax",
           "state_dict_from_jax", "vgg_state_dict_from_jax", "load_pth"]
