"""Paddle ``.pdparams`` key maps of the EMRT backbones (counterpart of
``emrt_tpu/utils/pdparams_maps.py``).

Each map function returns ``(pmap, smap, fold)``: the JAX package's flax
'/'-path -> (pd key, transform tag), the same format as
``pdparams.emrt_trunk_key_map``. Structure counts (blocks, stages) are read
from the flax tree. The CSwin, ViT, MixViT and HRNet maps are copies of the
JAX package's (pure Python). ``cnn_backbone_map`` extends its
``resnet_seg_backbone_map`` to ResNeXt and ResNeSt, which have no Paddle
layout in the JAX package: their names are the port's (``conv1``, ``bn1``,
``layer{s}.{b}.conv{j}/bn{j}``, ``downsample.{0,1}``,
``splat.{fc1,bn,fc2}``).
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

Maps = Tuple[Dict[str, tuple], Dict[str, tuple], Dict[str, str]]


def _mk():
    return {}, {}, {}


def _bn(pmap, smap, flax_prefix: str, pd_prefix: str):
    pmap[f"{flax_prefix}/scale"] = (f"{pd_prefix}.weight", "id")
    pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")
    smap[f"{flax_prefix}/mean"] = (f"{pd_prefix}._mean", "id")
    smap[f"{flax_prefix}/var"] = (f"{pd_prefix}._variance", "id")


def _ln(pmap, flax_prefix: str, pd_prefix: str):
    pmap[f"{flax_prefix}/scale"] = (f"{pd_prefix}.weight", "id")
    pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")


def _dense(pmap, flax_prefix: str, pd_prefix: str, bias: bool = True):
    pmap[f"{flax_prefix}/kernel"] = (f"{pd_prefix}.weight", "id")
    if bias:
        pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")


def _convp(pmap, flax_prefix: str, pd_prefix: str, bias: bool = False):
    pmap[f"{flax_prefix}/kernel"] = (f"{pd_prefix}.weight", "conv")
    if bias:
        pmap[f"{flax_prefix}/bias"] = (f"{pd_prefix}.bias", "id")


def _conv_bn(pmap, smap, flax_prefix: str, pd_conv: str, pd_bn: str):
    """Our ConvBNReLU (Conv_0 + BatchNorm_0) <- pd conv + norm pair."""
    _convp(pmap, f"{flax_prefix}/Conv_0", pd_conv)
    _bn(pmap, smap, f"{flax_prefix}/BatchNorm_0", pd_bn)


def _stage_blocks(flat_p, pat: str):
    """Sorted (stage, block) pairs present in the flax tree."""
    found = set()
    rx = re.compile(pat)
    for k in flat_p:
        m = rx.match(k)
        if m:
            found.add((int(m.group(1)), int(m.group(2))))
    return sorted(found)


def cswin_backbone_map(flat_p, flax="backbone", pd="encoder") -> Maps:
    """CSwinTransformer; our stage{s}_block{b} naming, attn_h <-> attns.0
    (horizontal stripes), attn_w <-> attns.1, single attn on the last
    stage (split_heads=False, cswin_transformer.py:317-336)."""
    pmap, smap, fold = _mk()
    _convp(pmap, f"{flax}/patch_embed", f"{pd}.patch_embedding.patch_embed",
           bias=True)
    _ln(pmap, f"{flax}/patch_norm", f"{pd}.patch_embedding.norm")
    blocks = _stage_blocks(flat_p, rf"{flax}/stage(\d+)_block(\d+)/norm1/scale")
    n_stages = max(s for s, _ in blocks) + 1 if blocks else 0
    for s, b in blocks:
        fl = f"{flax}/stage{s}_block{b}"
        pdb = f"{pd}.stages.{s}.blocks.{b}"
        _ln(pmap, f"{fl}/norm1", f"{pdb}.norm1")
        _ln(pmap, f"{fl}/norm2", f"{pdb}.norm2")
        _dense(pmap, f"{fl}/qkv", f"{pdb}.qkv")
        _dense(pmap, f"{fl}/proj", f"{pdb}.proj")
        _dense(pmap, f"{fl}/mlp/Dense_0", f"{pdb}.mlp.fc1")
        _dense(pmap, f"{fl}/mlp/Dense_1", f"{pdb}.mlp.fc2")
        if f"{fl}/attn/get_v/kernel" in flat_p:   # last stage: one branch
            _convp(pmap, f"{fl}/attn/get_v", f"{pdb}.attns.0.get_v", bias=True)
        else:
            _convp(pmap, f"{fl}/attn_h/get_v", f"{pdb}.attns.0.get_v", bias=True)
            _convp(pmap, f"{fl}/attn_w/get_v", f"{pdb}.attns.1.get_v", bias=True)
    for s in range(max(n_stages - 1, 0)):
        _convp(pmap, f"{flax}/merge{s}", f"{pd}.stages.{s}.merge.conv", bias=True)
        _ln(pmap, f"{flax}/merge_norm{s}", f"{pd}.stages.{s}.merge.norm")
    return pmap, smap, fold


def vit_backbone_map(flat_p, flax="backbone", pd="encoder.transformer",
                     block_fmt="block{i}") -> Maps:
    """VisualTransformer (vit.py): fused qkv -> per-head q/k/v slices."""
    pmap, smap, fold = _mk()
    emb = f"{pd}.embeddings"
    _convp(pmap, f"{flax}/patch_embed", f"{emb}.patch_embeddings", bias=True)
    pmap[f"{flax}/pos_embed"] = (f"{emb}.position_embeddings", "pos_embed")
    pmap[f"{flax}/cls_token"] = (f"{emb}.cls_token", "id")
    i = 0
    while f"{flax}/{block_fmt.format(i=i)}/norm1/scale" in flat_p:
        fl = f"{flax}/{block_fmt.format(i=i)}"
        pdb = f"{pd}.encoder.layers.{i}"
        _ln(pmap, f"{fl}/norm1", f"{pdb}.attn_norm")
        _ln(pmap, f"{fl}/norm2", f"{pdb}.mlp_norm")
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            pmap[f"{fl}/attn/{proj}/kernel"] = (f"{pdb}.attn.qkv.weight",
                                                f"qkv:{j}")
            pmap[f"{fl}/attn/{proj}/bias"] = (f"{pdb}.attn.qkv.bias",
                                              f"qkvb:{j}")
        pmap[f"{fl}/attn/out_proj/kernel"] = (f"{pdb}.attn.out.weight",
                                              "out_heads")
        pmap[f"{fl}/attn/out_proj/bias"] = (f"{pdb}.attn.out.bias", "id")
        _dense(pmap, f"{fl}/mlp/Dense_0", f"{pdb}.mlp.fc1")
        _dense(pmap, f"{fl}/mlp/Dense_1", f"{pdb}.mlp.fc2")
        i += 1
    return pmap, smap, fold


def mixvit_backbone_map(flat_p, flax="backbone", pd="backbone") -> Maps:
    """MixVisionTransformer (paddleseg_segformer/mix_transformer.py);
    pd block/stage indices are 1-based."""
    pmap, smap, fold = _mk()
    blocks = _stage_blocks(flat_p, rf"{flax}/stage(\d+)_block(\d+)/norm1/scale")
    n_stages = max(s for s, _ in blocks) + 1 if blocks else 0
    for s in range(n_stages):
        _convp(pmap, f"{flax}/patch_embed{s}", f"{pd}.patch_embed{s + 1}.proj",
               bias=True)
        _ln(pmap, f"{flax}/embed_norm{s}", f"{pd}.patch_embed{s + 1}.norm")
        _ln(pmap, f"{flax}/norm{s}", f"{pd}.norm{s + 1}")
    for s, b in blocks:
        fl = f"{flax}/stage{s}_block{b}"
        pdb = f"{pd}.block{s + 1}.{b}"
        _ln(pmap, f"{fl}/norm1", f"{pdb}.norm1")
        _ln(pmap, f"{fl}/norm2", f"{pdb}.norm2")
        _dense(pmap, f"{fl}/attn/q", f"{pdb}.attn.q")
        _dense(pmap, f"{fl}/attn/kv", f"{pdb}.attn.kv")
        _dense(pmap, f"{fl}/attn/proj", f"{pdb}.attn.proj")
        if f"{fl}/attn/sr/kernel" in flat_p:
            _convp(pmap, f"{fl}/attn/sr", f"{pdb}.attn.sr", bias=True)
            _ln(pmap, f"{fl}/attn/sr_norm", f"{pdb}.attn.norm")
        _dense(pmap, f"{fl}/ffn/fc1", f"{pdb}.mlp.fc1")
        _convp(pmap, f"{fl}/ffn/dwconv", f"{pdb}.mlp.dwconv.dwconv", bias=True)
        _dense(pmap, f"{fl}/ffn/fc2", f"{pdb}.mlp.fc2")
    return pmap, smap, fold


def hrnet_backbone_map(flat_p, flax="backbone", pd="backbone") -> Maps:
    """HRNet-W{w}: paddleseg ConvBNReLU/ConvBN register ._conv and
    ._batch_norm; fuse-layer BNs on our side are positional (_BN_{idx} in
    FuseLayer.__call__ creation order, which equals the reference's
    (i, j) registration order)."""
    pmap, smap, fold = _mk()

    def cbr(fl, pd_layer):
        _conv_bn(pmap, smap, fl, f"{pd_layer}._conv", f"{pd_layer}._batch_norm")

    cbr(f"{flax}/stem1", f"{pd}.conv_layer1_1")
    cbr(f"{flax}/stem2", f"{pd}.conv_layer1_2")

    # la1: 4 bottlenecks named bb_layer2_{i+1}
    for i in range(4):
        fl = f"{flax}/layer1_block{i}"
        pdb = f"{pd}.la1.bb_layer2_{i + 1}"
        for j in range(3):
            _convp(pmap, f"{fl}/Conv_{j}", f"{pdb}.conv{j + 1}._conv")
            _bn(pmap, smap, f"{fl}/_BN_{j}/BatchNorm_0",
                f"{pdb}.conv{j + 1}._batch_norm")
        if f"{fl}/Conv_3/kernel" in flat_p:
            _convp(pmap, f"{fl}/Conv_3", f"{pdb}.conv_down._conv")
            _bn(pmap, smap, f"{fl}/_BN_3/BatchNorm_0",
                f"{pdb}.conv_down._batch_norm")

    # transitions (hrnet.py:235-276: only channel-changing/new branches
    # get a conv; tr1 -> layers 1,2; tr2 -> layer 3; tr3 -> layer 4)
    cbr(f"{flax}/trans1_b0", f"{pd}.tr1.transition_tr1_layer_1")
    cbr(f"{flax}/trans1_b1", f"{pd}.tr1.transition_tr1_layer_2")
    cbr(f"{flax}/trans2_new", f"{pd}.tr2.transition_tr2_layer_3")
    cbr(f"{flax}/trans3_new", f"{pd}.tr3.transition_tr3_layer_4")

    # stages 2..4
    for stage, attr in ((2, "st2"), (3, "st3"), (4, "st4")):
        n_br = stage  # branches per stage
        m = 0
        while f"{flax}/stage{stage}_m{m}/branch0_block0/Conv_0/kernel" in flat_p:
            fl_m = f"{flax}/stage{stage}_m{m}"
            pd_m = f"{pd}.{attr}.stage_{attr}_{m + 1}"
            for br in range(n_br):
                b = 0
                while f"{fl_m}/branch{br}_block{b}/Conv_0/kernel" in flat_p:
                    fl = f"{fl_m}/branch{br}_block{b}"
                    pdb = (f"{pd_m}.branches_func."
                           f"bb_{attr}_{m + 1}_branch_layer_{br + 1}_{b + 1}")
                    for j in (0, 1):
                        _convp(pmap, f"{fl}/Conv_{j}", f"{pdb}.conv{j + 1}._conv")
                        _bn(pmap, smap, f"{fl}/_BN_{j}/BatchNorm_0",
                            f"{pdb}.conv{j + 1}._batch_norm")
                    b += 1
            # fuse: iterate exactly like FuseLayer.__call__ / the reference
            # FuseLayers registration (i outer, j inner, k down-chain)
            idx = 0
            for i in range(n_br):
                for j in range(n_br):
                    if j > i:
                        name = (f"{pd_m}.fuse_func."
                                f"residual_{attr}_{m + 1}_layer_{i + 1}_{j + 1}")
                        _convp(pmap, f"{fl_m}/fuse/up{i}_{j}", f"{name}._conv")
                        _bn(pmap, smap, f"{fl_m}/fuse/_BN_{idx}/BatchNorm_0",
                            f"{name}._batch_norm")
                        idx += 1
                    elif j < i:
                        for k in range(i - j):
                            name = (f"{pd_m}.fuse_func.residual_{attr}_{m + 1}"
                                    f"_layer_{i + 1}_{j + 1}_{k + 1}")
                            _convp(pmap, f"{fl_m}/fuse/down{i}_{j}_{k}",
                                   f"{name}._conv")
                            _bn(pmap, smap,
                                f"{fl_m}/fuse/_BN_{idx}/BatchNorm_0",
                                f"{name}._batch_norm")
                            idx += 1
            m += 1
    return pmap, smap, fold


def cnn_backbone_map(flat_p, flax="backbone", pd="backbone") -> Maps:
    """ResNet (7x7 or deep stem), ResNeXt and ResNeSt: flax's auto-named stem
    (``Conv_{0..2}`` or ResNeSt's ``stem{0..2}``, then ``_BN_{0..2}``) and
    blocks (``{Block}_{i}`` numbered across all four stages; the first block
    of every stage carries the projected shortcut) -> ``conv1`` (the deep
    stem's Sequential ``conv1.{0,1,3,4,6}``), ``bn1``,
    ``layer{s}.{b}.conv{j}/bn{j}``, ``downsample.{0,1}``, ``splat.*``."""
    pmap, smap, fold = _mk()

    def bnw(fl, pdp):
        _bn(pmap, smap, f"{fl}/BatchNorm_0", pdp)

    stem = "stem" if f"{flax}/stem0/kernel" in flat_p else "Conv_"
    if f"{flax}/{stem}2/kernel" in flat_p:
        for j, pdi in enumerate((0, 3, 6)):
            _convp(pmap, f"{flax}/{stem}{j}", f"{pd}.conv1.{pdi}")
        bnw(f"{flax}/_BN_0", f"{pd}.conv1.1")
        bnw(f"{flax}/_BN_1", f"{pd}.conv1.4")
        bnw(f"{flax}/_BN_2", f"{pd}.bn1")
    else:
        _convp(pmap, f"{flax}/Conv_0", f"{pd}.conv1")
        bnw(f"{flax}/_BN_0", f"{pd}.bn1")

    block = next((b for b in ("Bottleneck", "BasicBlock", "ResNeXtBottleneck",
                              "ResNeStBottleneck")
                  if f"{flax}/{b}_0/Conv_0/kernel" in flat_p), "Bottleneck")
    n_convs = 2 if block == "BasicBlock" else 3
    i = stage = b = 0
    while f"{flax}/{block}_{i}/Conv_0/kernel" in flat_p:
        fl = f"{flax}/{block}_{i}"
        projected = f"{fl}/Conv_{n_convs}/kernel" in flat_p
        stage, b = (stage + 1, 0) if projected else (stage, b)
        pdb = f"{pd}.layer{stage}.{b}"
        for j in range(n_convs):
            _convp(pmap, f"{fl}/Conv_{j}", f"{pdb}.conv{j + 1}")
            bnw(f"{fl}/_BN_{j}", f"{pdb}.bn{j + 1}")
        if projected:
            _convp(pmap, f"{fl}/Conv_{n_convs}", f"{pdb}.downsample.0")
            bnw(f"{fl}/_BN_{n_convs}", f"{pdb}.downsample.1")
        if f"{fl}/splat/fc1/kernel" in flat_p:
            _dense(pmap, f"{fl}/splat/fc1", f"{pdb}.splat.fc1")
            _bn(pmap, smap, f"{fl}/splat/bn", f"{pdb}.splat.bn")
            _dense(pmap, f"{fl}/splat/fc2", f"{pdb}.splat.fc2")
        i, b = i + 1, b + 1
    return pmap, smap, fold


# ---------------------------------------------------------------------------
# The zoo (copies of the JAX package's maps)
# ---------------------------------------------------------------------------

def vit_mla_backbone_map(flat_p, flax="encoder", pd="encoder") -> Maps:
    """ViT_MLA = ViT core + Conv_MLA aggregation + per-tap norm_{i}."""
    pmap, smap, fold = vit_backbone_map(flat_p, flax=f"{flax}/transformer",
                                        pd=f"{pd}.transformer")
    for i in range(4):
        _ln(pmap, f"{flax}/norm_{i}", f"{pd}.norm_{i}")
    for n in (2, 3, 4, 5):
        for suffix in ("_1x1", ""):
            _conv_bn(pmap, smap, f"{flax}/mla/mla_p{n}{suffix}",
                     f"{pd}.mla.mla_p{n}{suffix}.0", f"{pd}.mla.mla_p{n}{suffix}.1")
    return pmap, smap, fold


def swin_backbone_map(flat_p, flax="encoder", pd="encoder") -> Maps:
    """SwinTransformer (swin_transformer.py:575-651): patch_embedding
    conv+norm, stages.{s}.blocks.{b} with fused-qkv WindowAttention and a
    relative_position_bias_table, stages.{s}.downsample PatchMerging. The
    JAX Swin's per-stage norm{s} are the UperNet's layer_norms (mapped by
    ``upernet_key_map``)."""
    pmap, smap, fold = _mk()
    _convp(pmap, f"{flax}/patch_embed", f"{pd}.patch_embedding.patch_embed", bias=True)
    _ln(pmap, f"{flax}/patch_norm", f"{pd}.patch_embedding.norm")
    blocks = _stage_blocks(flat_p, rf"{flax}/stage(\d+)_block(\d+)/norm1/scale")
    n_stages = max(s for s, _ in blocks) + 1 if blocks else 0
    for s, b in blocks:
        fl = f"{flax}/stage{s}_block{b}"
        pdb = f"{pd}.stages.{s}.blocks.{b}"
        _ln(pmap, f"{fl}/norm1", f"{pdb}.norm1")
        _ln(pmap, f"{fl}/norm2", f"{pdb}.norm2")
        _dense(pmap, f"{fl}/attn/qkv", f"{pdb}.attn.qkv")
        _dense(pmap, f"{fl}/attn/proj", f"{pdb}.attn.proj")
        pmap[f"{fl}/attn/relative_position_bias_table"] = (
            f"{pdb}.attn.relative_position_bias_table", "id")
        _dense(pmap, f"{fl}/mlp/Dense_0", f"{pdb}.mlp.fc1")
        _dense(pmap, f"{fl}/mlp/Dense_1", f"{pdb}.mlp.fc2")
    for s in range(max(n_stages - 1, 0)):
        _ln(pmap, f"{flax}/merge{s}/norm", f"{pd}.stages.{s}.downsample.norm")
        _dense(pmap, f"{flax}/merge{s}/reduction", f"{pd}.stages.{s}.downsample.reduction",
               bias=False)
    return pmap, smap, fold


def focal_backbone_map(flat_p, flax="encoder", pd="encoder") -> Maps:
    """FocalTransformer (focal_transformer.py:819-1000): patch_embed,
    layers.{s}.blocks.{b} with fused-qkv focal attention (three bias-table
    families + fc pool_layers) and a PatchEmbed ``layers.{s}.downsample``."""
    pmap, smap, fold = _mk()
    _convp(pmap, f"{flax}/patch_embed/proj", f"{pd}.patch_embed.proj", bias=True)
    _ln(pmap, f"{flax}/patch_embed/norm", f"{pd}.patch_embed.norm")
    blocks = _stage_blocks(flat_p, rf"{flax}/stage(\d+)_block(\d+)/norm1/scale")
    n_stages = max(s for s, _ in blocks) + 1 if blocks else 0
    for s, b in blocks:
        fl = f"{flax}/stage{s}_block{b}"
        pdb = f"{pd}.layers.{s}.blocks.{b}"
        _ln(pmap, f"{fl}/norm1", f"{pdb}.norm1")
        _ln(pmap, f"{fl}/norm2", f"{pdb}.norm2")
        k = 0
        while f"{fl}/pool_layers{k}/kernel" in flat_p:
            _dense(pmap, f"{fl}/pool_layers{k}", f"{pdb}.pool_layers.{k}")
            k += 1
        _dense(pmap, f"{fl}/attn/qkv", f"{pdb}.attn.qkv")
        _dense(pmap, f"{fl}/attn/proj", f"{pdb}.attn.proj")
        attn = f"{pdb}.attn.relative_position_bias_table"
        pmap[f"{fl}/attn/relative_position_bias_table"] = (attn, "id")
        if f"{fl}/attn/relative_position_bias_table_to_neighbors" in flat_p:
            pmap[f"{fl}/attn/relative_position_bias_table_to_neighbors"] = (
                f"{attn}_to_neighbors", "id")
        k = 0
        while f"{fl}/attn/relative_position_bias_table_to_windows{k}" in flat_p:
            pmap[f"{fl}/attn/relative_position_bias_table_to_windows{k}"] = (
                f"{attn}_to_windows.{k}", "id")
            k += 1
        _dense(pmap, f"{fl}/mlp/Dense_0", f"{pdb}.mlp.fc1")
        _dense(pmap, f"{fl}/mlp/Dense_1", f"{pdb}.mlp.fc2")
    for s in range(max(n_stages - 1, 0)):
        _convp(pmap, f"{flax}/downsample{s}/proj", f"{pd}.layers.{s}.downsample.proj",
               bias=True)
        _ln(pmap, f"{flax}/downsample{s}/norm", f"{pd}.layers.{s}.downsample.norm")
    return pmap, smap, fold


def _uper_head_map(pmap, smap, flat_p, flax="decoder", pd="decoder"):
    """UperHead (decoders/uper_head.py:29-69 + psp_head.py:30-44)."""
    i = 0
    while f"{flax}/psp{i}/Conv_0/kernel" in flat_p:
        _conv_bn(pmap, smap, f"{flax}/psp{i}", f"{pd}.psp_modules.pool_branches.{i}.1",
                 f"{pd}.psp_modules.pool_branches.{i}.2")
        i += 1
    _conv_bn(pmap, smap, f"{flax}/bottleneck", f"{pd}.bottleneck.0", f"{pd}.bottleneck.1")
    i = 0
    while f"{flax}/lateral{i}/Conv_0/kernel" in flat_p:
        _conv_bn(pmap, smap, f"{flax}/lateral{i}", f"{pd}.lateral_convs.{i}.0",
                 f"{pd}.lateral_convs.{i}.1")
        _conv_bn(pmap, smap, f"{flax}/fpn{i}", f"{pd}.fpn_convs.{i}.0",
                 f"{pd}.fpn_convs.{i}.1")
        i += 1
    _conv_bn(pmap, smap, f"{flax}/fpn_bottleneck", f"{pd}.fpn_bottleneck.0",
             f"{pd}.fpn_bottleneck.1")
    _convp(pmap, f"{flax}/conv_seg", f"{pd}.conv_seg", bias=True)


def _fcn_head_map(pmap, smap, flat_p, flax="aux_decoder", pd="aux_decoder"):
    """Zoo FCNHead (decoders/fcn_head.py:45-67)."""
    i = 0
    while f"{flax}/conv{i}/Conv_0/kernel" in flat_p:
        _conv_bn(pmap, smap, f"{flax}/conv{i}", f"{pd}.convs.{i}.0", f"{pd}.convs.{i}.1")
        i += 1
    if f"{flax}/conv_cat/Conv_0/kernel" in flat_p:
        _conv_bn(pmap, smap, f"{flax}/conv_cat", f"{pd}.conv_cat.0", f"{pd}.conv_cat.1")
    _convp(pmap, f"{flax}/conv_seg", f"{pd}.conv_seg", bias=True)


def upernet_key_map(flat_p) -> Maps:
    """UperNet (upernet.py:41-106): a Swin, CSwin or Focal encoder, the
    top-level layer_norms, the UperHead decoder and the FCNHead aux."""
    if any(k.endswith("relative_position_bias_table_to_neighbors")
           or "relative_position_bias_table_to_windows" in k for k in flat_p):
        pmap, smap, fold = focal_backbone_map(flat_p)
        norms = "layer_norm{s}"
    elif any(k.startswith("encoder/stage0_block0/attn/qkv") for k in flat_p):
        pmap, smap, fold = swin_backbone_map(flat_p)
        norms = "encoder/norm{s}"
    elif any(k.startswith("encoder/stage0_block0/qkv") for k in flat_p):
        pmap, smap, fold = cswin_backbone_map(flat_p, flax="encoder", pd="encoder")
        norms = "layer_norm{s}"
    else:
        raise NotImplementedError("no .pdparams map for this UperNet encoder")
    s = 0
    while f"{norms.format(s=s)}/scale" in flat_p:
        _ln(pmap, norms.format(s=s), f"layer_norms.{s}")
        s += 1
    _uper_head_map(pmap, smap, flat_p)
    _fcn_head_map(pmap, smap, flat_p)
    return pmap, smap, fold


def fcn_key_map(flat_p) -> Maps:
    """FCN (fcn.py:22-64): the ResNet ``cnn_encoder``, ``head.conv_1.{0
    conv (biased), 1 bn}`` and ``head.cls``. The JAX package folds the head
    conv's bias into the BatchNorm mean."""
    pmap, smap, fold = cnn_backbone_map(flat_p, flax="cnn_encoder", pd="cnn_encoder")
    _conv_bn(pmap, smap, "head_conv", "head.conv_1.0", "head.conv_1.1")
    fold["head_conv/BatchNorm_0/mean"] = "head.conv_1.0.bias"
    _convp(pmap, "head_cls", "head.cls", bias=True)
    return pmap, smap, fold


def trans2seg_key_map(flat_p) -> Maps:
    """Trans2Seg (trans2seg.py:24-108 + trans2seg_transformer.py:88-421 +
    trans2seg_head.py:21-130)."""
    pmap, smap, fold = cnn_backbone_map(flat_p, flax="cnn_encoder", pd="cnn_encoder")
    enc, dec = "transformer_encoder", "transformer_decoder"
    _dense(pmap, "hybrid_embed", "hybrid_embed.proj")
    pmap["cls_token"] = (f"{enc}.cls_token", "id")
    pmap["pos_embed"] = (f"{enc}.pos_embed", "pos_embed")
    i = 0
    while f"enc_block{i}/norm1/scale" in flat_p:
        fl, pdb = f"enc_block{i}", f"{enc}.blocks_encoder.{i}"
        _ln(pmap, f"{fl}/norm1", f"{pdb}.norm1")
        _ln(pmap, f"{fl}/norm2", f"{pdb}.norm2")
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            pmap[f"{fl}/attn/{proj}/kernel"] = (f"{pdb}.attn.qkv.weight", f"qkv:{j}")
        pmap[f"{fl}/attn/out_proj/kernel"] = (f"{pdb}.attn.proj.weight", "out_heads")
        pmap[f"{fl}/attn/out_proj/bias"] = (f"{pdb}.attn.proj.bias", "id")
        _dense(pmap, f"{fl}/mlp/Dense_0", f"{pdb}.mlp.fc1")
        _dense(pmap, f"{fl}/mlp/Dense_1", f"{pdb}.mlp.fc2")
        i += 1
    _ln(pmap, "enc_norm", f"{enc}.norm")
    pmap["cls_embed"] = (f"{dec}.cls_embed", "id")
    i = 0
    while f"dec_block{i}/norm1/scale" in flat_p:
        fl, pdb = f"dec_block{i}", f"{dec}.blocks_decoder.{i}"
        for n in ("norm1", "norm1_clsembed", "norm2", "norm3", "norm4"):
            _ln(pmap, f"{fl}/{n}", f"{pdb}.{n}")
        _dense(pmap, f"{fl}/attn/fc_q", f"{pdb}.attn.fc_q", bias=False)
        _dense(pmap, f"{fl}/attn/fc_kv", f"{pdb}.attn.fc_kv", bias=False)
        _dense(pmap, f"{fl}/attn/proj", f"{pdb}.attn.proj")
        for m in ("mlp", "mlp2", "mlp3"):
            _dense(pmap, f"{fl}/{m}/Dense_0", f"{pdb}.{m}.fc1")
            _dense(pmap, f"{fl}/{m}/Dense_1", f"{pdb}.{m}.fc2")
        i += 1
    for lay in ("lay1", "lay2", "lay3"):
        pdl = f"cnn_head.{lay}.block"
        _convp(pmap, f"{lay}/depthwise", f"{pdl}.depthwise")
        _bn(pmap, smap, f"{lay}/bn_depth", f"{pdl}.bn_depth")
        _convp(pmap, f"{lay}/pointwise", f"{pdl}.pointwise")
        _bn(pmap, smap, f"{lay}/bn_point", f"{pdl}.bn_point")
    _convp(pmap, "conv_c1", "cnn_head.conv_c1.conv")
    _bn(pmap, smap, "conv_c1_bn", "cnn_head.conv_c1.bn")
    _convp(pmap, "pred", "cnn_head.pred", bias=True)
    return pmap, smap, fold


def dpt_key_map(flat_p) -> Maps:
    """DPT (dpt.py:25-41 + dpt_head.py:157-230); ``head.refine.3.resblock1``
    is registered by the reference but never runs."""
    pmap, smap, fold = vit_backbone_map(flat_p, flax="backbone", pd="backbone.transformer")
    for i in range(4):
        if f"readout_proj{i}/kernel" in flat_p:
            _dense(pmap, f"readout_proj{i}", f"head.readout_oper.{i}.proj.0")
        _convp(pmap, f"process{i}_proj", f"head.process.{i}.0", bias=True)
        _convp(pmap, f"layers_rn{i}", f"head.layers_rn.{i}")
    for i in (0, 1):
        pmap[f"process{i}_up/kernel"] = (f"head.process.{i}.1.weight", "convt")
        pmap[f"process{i}_up/bias"] = (f"head.process.{i}.1.bias", "id")
    _convp(pmap, "process3_down", "head.process.3.1", bias=True)

    def resblock(fl, pdb):
        for c in ("conv1", "conv2"):
            _convp(pmap, f"{fl}/{c}", f"{pdb}.{c}")
        for b in ("bn1", "bn2"):
            _bn(pmap, smap, f"{fl}/{b}", f"{pdb}.{b}")

    for i in range(4):
        if f"refine{i}/resblock1/conv1/kernel" in flat_p:
            resblock(f"refine{i}/resblock1", f"head.refine.{i}.resblock1")
        resblock(f"refine{i}/resblock2", f"head.refine.{i}.resblock2")
        _convp(pmap, f"refine{i}/out_conv", f"head.refine.{i}.out_conv", bias=True)
    _convp(pmap, "head_conv", "head.head.0")
    _bn(pmap, smap, "head_bn", "head.head.1")
    _convp(pmap, "head_cls", "head.head.4", bias=True)
    return pmap, smap, fold


def setr_key_map(flat_p) -> Maps:
    """SETR MLA / PUP / Naive (setr.py:28-170); the decoder family is read
    from the flax tree."""
    if any(k.startswith("decoder/head2_conv0") for k in flat_p):
        pmap, smap, fold = vit_mla_backbone_map(flat_p)
        for n in (2, 3, 4, 5):
            for c, seq in ((0, 0), (1, 3)):
                _conv_bn(pmap, smap, f"decoder/head{n}_conv{c}", f"decoder.head{n}.{seq}",
                         f"decoder.head{n}.{seq + 1}")
        _convp(pmap, "decoder/cls", "decoder.cls", bias=True)
        for n in (2, 3, 4, 5):
            fl = f"aux_decoder{n}"
            if f"{fl}/aux/kernel" in flat_p:
                _convp(pmap, f"{fl}/aux", f"{fl}.aux")
            elif f"{fl}/aux_0/kernel" in flat_p:
                _convp(pmap, f"{fl}/aux_0", f"{fl}.aux_0")
                _convp(pmap, f"{fl}/aux_1", f"{fl}.aux_1")
        return pmap, smap, fold
    pmap, smap, fold = vit_backbone_map(flat_p, flax="encoder", pd="encoder.transformer")

    def up_head(prefix):
        _ln(pmap, f"{prefix}/norm", f"{prefix}.norm")
        i = 0
        while f"{prefix}/conv_{i}/kernel" in flat_p:
            _convp(pmap, f"{prefix}/conv_{i}", f"{prefix}.conv_{i}", bias=True)
            if f"{prefix}/syncbn_fc_{i}/scale" in flat_p:
                _bn(pmap, smap, f"{prefix}/syncbn_fc_{i}", f"{prefix}.syncbn_fc_{i}")
            i += 1

    up_head("decoder")
    for n in (2, 3, 4, 5):
        if f"aux_decoder{n}/conv_0/kernel" in flat_p:
            up_head(f"aux_decoder{n}")
    return pmap, smap, fold
