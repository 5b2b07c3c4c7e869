"""emrt_tpu_torch: the EMRT segmentation framework in PyTorch for one NVIDIA H100.

The port of ``emrt_tpu`` (JAX on a TPU), which stays beside it as the
reference. Module and class names follow ``emrt_tpu`` so each file has an
obvious counterpart; inside, the code is PyTorch: ``nn.Module``s, NCHW
activations, an explicit ``device``. The multi-scale deformable attention
runs through hand-written CUDA kernels for Hopper on CUDA tensors, forward
(``csrc/ms_deform_attn_fwd.cu``) and backward (``csrc/ms_deform_attn_bwd.cu``),
and through its plain PyTorch version (and its autograd) on CPU tensors.

This package never imports ``jax``, ``flax`` or ``emrt_tpu``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
