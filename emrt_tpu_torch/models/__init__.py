"""Model registry (counterpart of ``emrt_tpu/models/__init__.py``).

Only EMRT with a ResNet backbone is ported so far; every other model name
raises (the zoo is ROADMAP.md queue 1, M11).
"""
from __future__ import annotations

import torch

from .deformable_transformer import MSDeformableAttention
from .emrt import EMRT, build_emrt


def get_model(config, device=None, dtype=None, use_kernel: bool = True):
    """Build a model (``nn.Module`` on ``device``) from config.MODEL.NAME.

    dtype: None -> TRAIN.DTYPE ("bfloat16" runs under autocast).
    use_kernel: True sends the deformable-attention core of CUDA tensors to
    the CUDA kernels; False runs its plain PyTorch version everywhere.
    """
    if dtype is None:
        dtype = (torch.bfloat16 if getattr(config.TRAIN, "DTYPE", "float32") == "bfloat16"
                 else torch.float32)
    name = config.MODEL.NAME
    if "EMRT" not in name:
        raise NotImplementedError(
            f"model {name}: only EMRT is ported; the zoo is ROADMAP.md queue 1, M11")
    model = build_emrt(config, dtype=dtype)
    for m in model.modules():
        if isinstance(m, MSDeformableAttention):
            m.use_kernel = use_kernel
    return model.to(device)
