from .fused_act import (FusedLeakyReLU, ScaledLeakyReLU, fused_leaky_relu,
                        fused_leaky_relu_plain, scaled_leaky_relu)
from .modulated_conv import conv2d, conv_transpose2d, modulated_conv2d
from .upfirdn import (make_resample_kernel, upfirdn2d, upfirdn_downsample,
                      upfirdn_smooth, upfirdn_upsample)

__all__ = [
    "FusedLeakyReLU", "ScaledLeakyReLU", "fused_leaky_relu",
    "fused_leaky_relu_plain", "scaled_leaky_relu", "conv2d",
    "conv_transpose2d", "modulated_conv2d",
    "make_resample_kernel", "upfirdn2d", "upfirdn_downsample",
    "upfirdn_smooth", "upfirdn_upsample",
]
