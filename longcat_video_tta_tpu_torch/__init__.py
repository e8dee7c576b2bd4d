"""PyTorch/CUDA port of the LongCat-Video TTA framework.

A second package beside the JAX reference (``longcat_video_tta_tpu``):
module paths mirror it one to one, so every port module has its
counterpart under the same name. The port imports ``torch`` and never
``jax``, and keeps its own copy of whatever it needs from the reference
(configs, host IO, metrics). Attention runs through a hand-written CUDA
kernel (``ops/flash_attention.py`` + ``csrc/flash_fwd.cu``) for CUDA
tensors and through its plain PyTorch version for CPU tensors.
"""

__version__ = "0.1.0"
