"""Model-zoo registry for the models other than EMRT (counterpart of
``emrt_tpu/models/zoo.py``; reference dispatch src/models/__init__.py:14-40).

MODEL.NAME substrings in the JAX package's order: SETR, FCN, UperNet,
SegFormer, Segmenter, Trans2Seg, DPT. SegFormer and Segmenter are not
ported yet (ROADMAP.md queue 1, M11).
"""
from __future__ import annotations

import torch


def get_zoo_model(config, dtype=torch.float32):
    name = config.MODEL.NAME
    if "SETR" in name:
        from .setr import build_setr
        return build_setr(config, dtype=dtype)
    if "FCN" in name:
        from .fcn import FCN
        return FCN(num_classes=config.DATA.NUM_CLASSES,
                   backbone=config.MODEL.ENCODER.TYPE.lower(),
                   output_stride=config.MODEL.OUTPUT_STRIDE, dtype=dtype)
    if "UperNet" in name:
        from .upernet import build_upernet
        return build_upernet(config, dtype=dtype)
    if "Segformer" in name or "SegFormer" in name or "Segmenter" in name:
        raise NotImplementedError(f"model {name}: SegFormer and Segmenter are not ported "
                                  f"yet (ROADMAP.md queue 1, M11)")
    if "Trans2Seg" in name:
        from .trans2seg import build_trans2seg
        return build_trans2seg(config, dtype=dtype)
    if "DPT" in name:
        from .dpt import build_dpt
        return build_dpt(config, dtype=dtype)
    raise NotImplementedError(f"model {name} is not supported yet")
