"""Weights carried into the port: Paddle ``.pdparams`` and the JAX package's
parameters (counterpart of ``emrt_tpu/utils/pdparams.py``).

The port's state-dict keys are the reference's Paddle module paths
(``backbone.layer1.0.conv1.weight``,
``model.encoder.layers.0.self_attn.value_proj.weight``, ...), so a
``.pdparams`` dict loads almost as-is. Two layout rules remain:

* Paddle ``nn.Linear`` weights are ``[in, out]``; torch's are ``[out, in]``
  (the fused decoder ``in_proj_weight`` too);
* Paddle BatchNorm statistics are ``_mean`` / ``_variance``; torch's are
  ``running_mean`` / ``running_var``.

(A Paddle ``Conv2DTranspose`` weight is torch's [in, out, kh, kw] as it is.)
A ViT position table of another token count is re-interpolated to the
model's (``checkpoint.py::interp_pos_embed``).

A prefix-less ImageNet ResNet file (``conv1``, ``bn1``, ``layer{s}.{b}...``,
``fc``), which the reference loads straight into its backbone, loads into
``backbone.`` as it is, the 7x7 stem and the deep stem's ``conv1.{0,1,3,4,6}``
alike; ``fc.*`` is unused and the rest of the model keeps its values.

``state_dict_from_flax`` inverts the JAX package's converter
(``emrt_tpu/utils/pdparams.py::_apply``), so one set of weights runs through
both packages; the parity tests rely on it.
"""
from __future__ import annotations

import io
import pickle
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from .checkpoint import interp_pos_embed

_BN_STATS = (("_mean", "running_mean"), ("_variance", "running_var"))
_POS_TABLES = ("position_embeddings", "pos_embed")


# ---------------------------------------------------------------------------
# Reader (copied from the JAX package: pure Python)
# ---------------------------------------------------------------------------

class _PermissiveUnpickler(pickle.Unpickler):
    """Unpickler that tolerates paddle-internal classes by substituting
    inert stand-ins (state dicts saved by paddle>=2.0 are numpy-only, but
    older files may reference paddle modules for metadata objects)."""

    def find_class(self, module: str, name: str):
        if module.startswith(("paddle", "fluid")):
            class _Stub:  # pragma: no cover - only hit on legacy files
                def __init__(self, *a, **k):
                    self.args = a

                def __setstate__(self, state):
                    self.state = state
            _Stub.__name__ = name
            return _Stub
        return super().find_class(module, name)


def read_pdparams(path: str) -> Dict[str, np.ndarray]:
    """Read a ``paddle.save``d state dict as ``{key: np.ndarray}``."""
    with open(path, "rb") as f:
        data = f.read()
    obj = _PermissiveUnpickler(io.BytesIO(data), encoding="latin1").load()
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a pickled state dict, "
                         f"got {type(obj)}")
    out = {}
    for k, v in obj.items():
        arr = np.asarray(getattr(v, "numpy", lambda: v)())
        out[str(k)] = arr
    return out


# ---------------------------------------------------------------------------
# EMRT key maps: flax '/'-path -> (pdparams key, transform tag), copied from
# the JAX package (pure Python)
# ---------------------------------------------------------------------------

def emrt_trunk_key_map(num_enc_layers: int = 4, num_dec_layers: int = 2):
    """EMRT trunk mapping shared by all backbone variants.

    Tags: 'conv' (NCHW->NHWC), 'id' (copy), 'qkv:i' / 'qkvb:i' (fused in_proj
    slice), 'out_heads' (out_proj -> per-head in-dim). Returns (param_map,
    stats_map, fold_bias) where fold_bias maps a flax BN-mean stats path to
    the pd conv-bias key the JAX package folds into it.
    """
    pmap: Dict[str, tuple] = {}
    smap: Dict[str, tuple] = {}
    fold: Dict[str, str] = {}

    def bn(flax_prefix: str, pd_prefix: str):
        pmap[f"{flax_prefix}/scale"] = (f"{pd_prefix}.weight", "id")
        pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")
        smap[f"{flax_prefix}/mean"] = (f"{pd_prefix}._mean", "id")
        smap[f"{flax_prefix}/var"] = (f"{pd_prefix}._variance", "id")

    def gn(flax_prefix: str, pd_prefix: str):
        pmap[f"{flax_prefix}/scale"] = (f"{pd_prefix}.weight", "id")
        pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")

    def dense(flax_prefix: str, pd_prefix: str):
        pmap[f"{flax_prefix}/kernel"] = (f"{pd_prefix}.weight", "id")
        pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")

    # --- spatial branch (paddle_EMRT.py:80-113) ---
    for i in range(3):
        for conv_name, seq in (("conv1", 0), ("conv2", 3)):
            base = f"spatial_branch/enc{i}_{conv_name}"
            pmap[f"{base}/Conv_0/kernel"] = (
                f"spatial_branch.Enc{i}.encode.{seq}.weight", "conv")
            bn(f"{base}/BatchNorm_0", f"spatial_branch.Enc{i}.encode.{seq + 1}")

    # --- PSP module (paddle_EMRT.py:50-78) ---
    for i in range(4):
        base = f"psp_module/pool_branch{i}"
        pmap[f"{base}/Conv_0/kernel"] = (
            f"psp_module.pool_branches.{i}.1.weight", "conv")
        bn(f"{base}/BatchNorm_0", f"psp_module.pool_branches.{i}.2")

    # --- UpHead (paddle_EMRT.py:133-142): conv_0..2 carry biases folded
    # into the following BN's running mean; conv_3 is the classifier ---
    for i in range(3):
        pmap[f"uphead/conv{i}/Conv_0/kernel"] = (f"uphead.conv_{i}.weight", "conv")
        bn(f"uphead/conv{i}/BatchNorm_0", f"uphead.syncbn_fc_{i}")
        fold[f"uphead/conv{i}/BatchNorm_0/mean"] = f"uphead.conv_{i}.bias"
    pmap["uphead/cls/kernel"] = ("uphead.conv_3.weight", "conv")
    pmap["uphead/cls/bias"] = ("uphead.conv_3.bias", "id")

    # --- cls_psp (paddle_EMRT.py:201-209) ---
    for i, seq in ((0, 0), (1, 3)):
        pmap[f"cls_psp{i}/Conv_0/kernel"] = (f"cls_psp.{seq}.weight", "conv")
        bn(f"cls_psp{i}/BatchNorm_0", f"cls_psp.{seq + 1}")

    # --- EFP (paddle_EMRT.py:13-48) ---
    for i in range(3):
        for j in (1, 2):
            base = f"efp/conv{i}/conv{j}"
            pmap[f"{base}/Conv_0/kernel"] = (f"EFP.conv{i}.conv{j}.{0}.weight", "conv")
            bn(f"{base}/BatchNorm_0", f"EFP.conv{i}.conv{j}.{1}")

    # --- aux FCNHead (decoders/fcn_head.py:46-67) ---
    pmap["auxlayer/conv0/Conv_0/kernel"] = ("auxlayer.convs.0.0.weight", "conv")
    bn("auxlayer/conv0/BatchNorm_0", "auxlayer.convs.0.1")
    pmap["auxlayer/conv_seg/kernel"] = ("auxlayer.conv_seg.weight", "conv")
    pmap["auxlayer/conv_seg/bias"] = ("auxlayer.conv_seg.bias", "id")

    # --- EncoderDecoder ('model.' prefix, transformer_encoder_decoder.py) ---
    ed = "encoder_decoder"
    for i in range(3):
        pmap[f"{ed}/input_proj{i}/kernel"] = (f"model.input_proj.{i}.0.weight", "conv")
        pmap[f"{ed}/input_proj{i}/bias"] = (f"model.input_proj.{i}.0.bias", "id")
        gn(f"{ed}/input_gn{i}", f"model.input_proj.{i}.1")
    pmap[f"{ed}/level_embed"] = ("model.level_embed.weight", "id")
    pmap[f"{ed}/query_pos_embed"] = ("model.query_pos_embed.weight", "id")
    dense(f"{ed}/reference_points", "model.reference_points")

    def deform(flax_prefix: str, pd_prefix: str):
        for part in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            dense(f"{flax_prefix}/{part}", f"{pd_prefix}.{part}")

    for l in range(num_enc_layers):
        fl = f"{ed}/encoder_layer{l}"
        pd = f"model.encoder.layers.{l}"
        deform(f"{fl}/self_attn", f"{pd}.self_attn")
        for j in range(3):
            pmap[f"{fl}/ConvEnhance_0/conv{j}/kernel"] = (
                f"{pd}.conv{j}.0.weight", "conv")
            gn(f"{fl}/ConvEnhance_0/gn{j}", f"{pd}.conv{j}.1")
        dense(f"{fl}/linear1", f"{pd}.linear1")
        dense(f"{fl}/linear2", f"{pd}.linear2")
        gn(f"{fl}/norm1", f"{pd}.norm1")  # LayerNorm: same scale/bias naming
        gn(f"{fl}/norm2", f"{pd}.norm2")

    for l in range(num_dec_layers):
        fl = f"{ed}/decoder_layer{l}"
        pd = f"model.decoder.layers.{l}"
        # fused-qkv MHSA (layers.py:221-230: column slices q/k/v)
        for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            pmap[f"{fl}/self_attn/{proj}/kernel"] = (
                f"{pd}.self_attn.in_proj_weight", f"qkv:{i}")
            pmap[f"{fl}/self_attn/{proj}/bias"] = (
                f"{pd}.self_attn.in_proj_bias", f"qkvb:{i}")
        pmap[f"{fl}/self_attn/out_proj/kernel"] = (
            f"{pd}.self_attn.out_proj.weight", "out_heads")
        pmap[f"{fl}/self_attn/out_proj/bias"] = (
            f"{pd}.self_attn.out_proj.bias", "id")
        deform(f"{fl}/cross_attn", f"{pd}.cross_attn")
        dense(f"{fl}/linear1", f"{pd}.linear1")
        dense(f"{fl}/linear2", f"{pd}.linear2")
        gn(f"{fl}/norm1", f"{pd}.norm1")
        gn(f"{fl}/norm2", f"{pd}.norm2")
        gn(f"{fl}/norm3", f"{pd}.norm3")

    return pmap, smap, fold


def build_key_map(flat_p, model_name: str = "EMRT", encoder_type: str = "resnet50"):
    """(pmap, smap, fold) of a model, chosen as
    ``emrt_tpu/utils/pdparams.py::build_key_map`` chooses. An EMRT: the
    trunk plus its backbone's map (MODEL.NAME first, then the encoder type),
    with the CNN backbones the JAX package has no map for (resnet50c, the
    other depths, ResNeXt50, ResNeSt50) under ``cnn_backbone_map``. The zoo
    by MODEL.NAME: SETR, UperNet (Swin, CSwin, Focal), Trans2Seg, DPT, FCN."""
    from . import pdparams_maps as M

    name = model_name or ""
    enc = (encoder_type or "").lower()
    if "EMRT" not in name:
        for tags, zoo_map in ((("SETR",), M.setr_key_map),
                              (("UperNet", "Upernet"), M.upernet_key_map),
                              (("Trans2Seg", "Trans2seg"), M.trans2seg_key_map),
                              (("DPT",), M.dpt_key_map), (("FCN",), M.fcn_key_map)):
            if any(t in name for t in tags):
                return zoo_map(flat_p)
        raise NotImplementedError(f"model {model_name!r}: no .pdparams key map in the port "
                                  f"(SegFormer and Segmenter: ROADMAP.md queue 1, M11)")
    n_enc = sum(1 for k in flat_p if k.startswith("encoder_decoder/encoder_layer")
                and k.endswith("norm1/scale"))
    n_dec = sum(1 for k in flat_p if k.startswith("encoder_decoder/decoder_layer")
                and k.endswith("norm1/scale"))
    maps = emrt_trunk_key_map(n_enc, n_dec)
    if "EMRT_CSwin" in name or enc == "cswintransformer":
        backbone = M.cswin_backbone_map(flat_p, flax="backbone", pd="encoder")
    elif "EMRT_ViT" in name or enc == "vit":
        backbone = M.vit_backbone_map(flat_p, flax="backbone", pd="encoder.transformer")
    elif "EMRT_HRNet" in name or enc == "hrnet":
        backbone = M.hrnet_backbone_map(flat_p, flax="backbone", pd="backbone")
        for i in range(3):   # strided pre-projections (hrnet_backbone.py:190-197)
            M._conv_bn(*backbone[:2], f"input_pre{i}", f"input_proj.{i}.0",
                       f"input_proj.{i}.1")
    elif enc == "segformer_b4":
        backbone = M.mixvit_backbone_map(flat_p, flax="backbone", pd="backbone.backbone")
    elif enc.startswith("resnet") or enc in ("resnext50", "resnest50", ""):
        backbone = M.cnn_backbone_map(flat_p, flax="backbone", pd="backbone")
    else:
        raise NotImplementedError(f"no .pdparams key map for EMRT backbone {encoder_type!r}")
    if any(k.startswith("tap_norm") for k in flat_p):
        for i in range(4):   # per-tap LayerNorms (cswin_backbone.py:236-251)
            M._ln(backbone[0], f"tap_norm{i}", f"layer_norms.{i}")
    for d, part in zip(maps, backbone):
        d.update(part)
    return maps


# ---------------------------------------------------------------------------
# Paddle / flax -> the port
# ---------------------------------------------------------------------------

def _torch_key(pd_key: str) -> str:
    for pd_name, torch_name in _BN_STATS:
        if pd_key.endswith(f".{pd_name}"):
            return pd_key[:-len(pd_name)] + torch_name
    return pd_key


def _pd_key(torch_key: str) -> str:
    for pd_name, torch_name in _BN_STATS:
        if torch_key.endswith(f".{torch_name}"):
            return torch_key[:-len(torch_name)] + pd_name
    return torch_key


def state_dict_from_flax(flat_params, flat_stats, model_name: str = "EMRT",
                         encoder_type: str = "resnet50") -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from the JAX package's parameters.

    flat_params / flat_stats: ``{'/'-joined flax path: array}`` of a JAX
    model's params and batch_stats (any subset: keys the map does not name
    are skipped); model_name / encoder_type: MODEL.NAME and
    MODEL.ENCODER.TYPE, which pick the backbone's map (``build_key_map``). Inverts each tag of the JAX converter: conv HWIO ->
    OIHW; a Dense kernel [in, out] -> Linear [out, in]; the q/k/v kernels
    and biases -> the fused ``in_proj_weight`` / ``in_proj_bias``; the
    per-head ``out_proj`` kernel -> [out, in]; a ConvTranspose kernel
    (flipped by the JAX converter) -> [in, out, kh, kw] unflipped. Where the
    JAX package folds a conv bias into its BN mean (EMRT's UpHead, FCN's
    head), the conv bias is 0 and the mean is taken as it is.
    """
    pmap, smap, fold = build_key_map(flat_params, model_name, encoder_type)
    out: Dict[str, np.ndarray] = {}
    fused: Dict[str, list] = {}
    for flat, mapping in ((flat_params, pmap), (flat_stats, smap)):
        for fkey, (pdkey, tag) in mapping.items():
            if fkey not in flat:
                continue
            a = np.asarray(flat[fkey], dtype=np.float32)
            key = _torch_key(pdkey)
            if tag == "conv":
                out[key] = a.transpose(3, 2, 0, 1)
            elif tag == "convt":     # the JAX converter's flipped [kh, kw, in, out]
                out[key] = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif tag == "pos_embed":     # the JAX converter interpolates on load
                out[key] = a
            elif tag == "id":
                out[key] = a.T if fkey.endswith("/kernel") and a.ndim == 2 else a
            elif tag == "out_heads":
                out[key] = a.reshape(-1, a.shape[-1]).T
            elif tag.split(":")[0] in ("qkv", "qkvb"):
                block = a.reshape(a.shape[0], -1).T if tag.startswith("qkv:") else a.reshape(-1)
                fused.setdefault(key, [None] * 3)[int(tag.split(":")[1])] = block
            else:
                raise ValueError(f"unknown transform {tag} for {fkey}")
    for key, blocks in fused.items():
        out[key] = np.concatenate(blocks, axis=0)
    for stats_key, bias_key in fold.items():
        if stats_key in flat_stats:
            out[bias_key] = np.zeros(np.shape(flat_stats[stats_key]), np.float32)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _transposed_keys(model: nn.Module) -> set:
    """State-dict keys stored [in, out] by Paddle: Linear weights and the
    fused attention ``in_proj_weight``."""
    keys = set()
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.Linear):
            keys.add(f"{prefix}weight")
        if isinstance(getattr(m, "in_proj_weight", None), nn.Parameter):
            keys.add(f"{prefix}in_proj_weight")
    return keys


def is_backbone_only_pdparams(pd_keys) -> bool:
    """True for a prefix-less ImageNet ResNet state dict (reference
    resnet.py:238-243; ``emrt_tpu/utils/pdparams.py::is_backbone_only_pdparams``)."""
    keys = set(pd_keys)
    has_stem = "conv1.weight" in keys or "conv1.0.weight" in keys
    has_blocks = "layer1.0.conv1.weight" in keys
    prefixed = any(k.startswith(("backbone.", "model.", "spatial_branch.",
                                 "encoder.", "decode_head.", "uphead."))
                   for k in keys)
    return has_stem and has_blocks and not prefixed


def load_pdparams(model: nn.Module, pd: Dict[str, np.ndarray]) -> dict:
    """Load a Paddle-layout state dict (``read_pdparams`` output) into model.

    Returns a report {matched, missing, unused}; raises on a shape mismatch,
    except that a ViT position table of another token count is bilinearly
    re-interpolated (``checkpoint.py::interp_pos_embed``, as the JAX
    converter does). Tensors the model has but ``pd`` lacks keep their
    current values. Keys
    starting with one of the model's ``pdparams_unused`` prefixes (weights
    the reference registers but its forward never reads) are not reported.
    A prefix-less ImageNet ResNet dict loads into the model's ``backbone``
    (its classifier ``fc.*`` is not reported).
    """
    if is_backbone_only_pdparams(pd) and hasattr(model, "backbone"):
        pd = {f"backbone.{k}": v for k, v in pd.items() if not k.startswith("fc.")}
    transposed = _transposed_keys(model)
    target = model.state_dict()
    new, missing, used = {}, [], set()
    for key, t in target.items():
        if key.endswith("num_batches_tracked"):
            continue
        pd_key = _pd_key(key)
        if pd_key not in pd:
            missing.append(pd_key)
            continue
        a = np.asarray(pd[pd_key], dtype=np.float32)
        if key in transposed:
            a = a.T
        if a.shape != tuple(t.shape) and key.endswith(_POS_TABLES) and a.ndim == 3:
            a = interp_pos_embed(a, tuple(t.shape))
        if a.shape != tuple(t.shape):
            raise ValueError(f"{pd_key}: shape {a.shape} does not fit {key} "
                             f"{tuple(t.shape)}")
        new[key] = torch.from_numpy(np.ascontiguousarray(a))
        used.add(pd_key)
    model.load_state_dict(new, strict=False)
    dead = tuple(getattr(model, "pdparams_unused", ()))
    unused = sorted(k for k in pd if k not in used and not k.startswith(dead))
    return {"matched": len(used), "missing": missing, "unused": unused}
