"""Model registry (counterpart of ``emrt_tpu/models/__init__.py``).

MODEL.NAME containing "EMRT" builds EMRT with any backbone of the JAX
package's EMRT dispatch (``models/emrt.py``); every other name goes to the
zoo (``models/zoo.py``): FCN, SETR, UperNet (Swin, CSwin, Focal), DPT and
Trans2Seg.
"""
from __future__ import annotations

import torch

from .deformable_transformer import MSDeformableAttention
from .emrt import EMRT, build_emrt
from .zoo import get_zoo_model


def get_model(config, device=None, dtype=None, use_kernel: bool = True):
    """Build a model (``nn.Module`` on ``device``) from config.MODEL.NAME.

    dtype: None -> TRAIN.DTYPE ("bfloat16" runs under autocast).
    use_kernel: True sends the deformable-attention core of CUDA tensors to
    the CUDA kernels; False runs its plain PyTorch version everywhere. The
    zoo's models run no deformable attention and ignore it.
    """
    if dtype is None:
        dtype = (torch.bfloat16 if getattr(config.TRAIN, "DTYPE", "float32") == "bfloat16"
                 else torch.float32)
    if "EMRT" not in config.MODEL.NAME:
        return get_zoo_model(config, dtype=dtype).to(device)
    model = build_emrt(config, dtype=dtype)
    for m in model.modules():
        if isinstance(m, MSDeformableAttention):
            m.use_kernel = use_kernel
    return model.to(device)
