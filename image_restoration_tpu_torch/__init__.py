"""PyTorch/CUDA port of image_restoration_tpu for NVIDIA Hopper.

The JAX package `image_restoration_tpu` stays the reference; this package
serves the same networks under the same `type:` names and parameter keys,
with every Pallas kernel on a ported path rewritten by hand for sm_90a
(`csrc/`). Public functions and `nn.Module.forward`s take and return NHWC
tensors, as the JAX functions do. Entry points take `device=`; left unset it
means "cuda" and raises when there is no GPU.

This package imports torch and never jax or image_restoration_tpu.
"""

__version__ = "0.1.0"
