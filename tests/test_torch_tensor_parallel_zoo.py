"""Tensor parallelism of the zoo's ViT attentions (``models/backbones/vit.py``
``Attention``, DeiT's and Trans2Seg's): the JAX package's ``tp_rule`` splits
the ``MultiHeadAttention`` of every ``ViTBlock`` (EMRT-ViT, SETR, DPT,
Segmenter, Trans2Seg), and nothing of Swin, CSwin, Focal, SegFormer or FCN.

- the rule: for each family of ``test_torch_zoo.FAMILIES`` below, the port
  splits exactly the parameters ``tp_rule`` splits in the JAX model (under
  the family's ``.pdparams`` key map), and each rank's shard is the one
  ``tp_shard_params`` gives its device;
- SETR-PUP, DeiT Segmenter with the MaskTransformer and Trans2Seg (a
  bias-free ``qkv``), split over two ranks on gloo (one head each but
  Trans2Seg's two): eval-mode logits within 1e-5 x max|logit| of one
  process's, the loss within 1e-6 relative and the gathered gradients within
  1e-5 (relative L2) of its gradients.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from emrt_tpu.parallel import create_mesh  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_tensor_parallel import _jax_split_paths  # noqa: E402
from test_torch_tensor_parallel_ranks import tp_zoo_rank  # noqa: E402
from test_torch_zoo import FAMILIES, _labels, bridged, images, torch_model  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.parallel.tensor import shard_state_dict, splits_of  # noqa: E402
from emrt_tpu_torch.utils.pdparams import (_torch_key, build_key_map,  # noqa: E402
                                            state_dict_from_flax)

torch.set_num_threads(1)

# family -> the split parameters of one ViT block (fused q/k/v weight and
# bias, the output projection's weight)
RULE_FAMILIES = {"setr_pup": 3, "setr_mla": 3, "dpt_project": 3, "trans2seg": 2,
                 "segmenter_vit_mask": 3, "segmenter_deit_mask": 3, "upernet_swin": 0,
                 "upernet_cswin": 0, "upernet_focal_a": 0, "segformer": 0, "fcn": 0}


@pytest.mark.parametrize("family", RULE_FAMILIES)
def test_the_rule_splits_tp_rules_parameters_of_the_zoo(family):
    name, encoder = FAMILIES[family][:2]
    _, variables, full = bridged(family)
    flat = _flat(variables["params"])
    jax_split = _jax_split_paths(variables["params"])
    pmap, _, _ = build_key_map(flat, name, encoder)
    splits = splits_of(torch_model(family))
    assert set(splits) == {_torch_key(pmap[path][0]) for path in jax_split}
    per_block = RULE_FAMILIES[family]
    assert (len(splits) > 0) == (per_block > 0) and len(splits) % max(per_block, 1) == 0
    if not splits:
        return
    mesh = create_mesh(data=1, model=2, devices=jax.devices()[:2])
    for m in range(2):
        shard_m = {}
        for path, spec in jax_split.items():
            placed = jax.device_put(flat[path], NamedSharding(mesh, spec))
            shard_m[path] = next(np.asarray(s.data) for s in placed.addressable_shards
                                 if s.device == mesh.devices[0, m, 0])
        got = state_dict_from_flax({**flat, **shard_m}, _flat(variables["batch_stats"]),
                                   name, encoder)
        mine = shard_state_dict(full, m, 2, splits)
        for key in splits:
            np.testing.assert_array_equal(mine[key].numpy(), got[key].numpy(), err_msg=key)


@pytest.mark.parametrize("family", ["setr_pup", "segmenter_deit_mask", "trans2seg"])
def test_zoo_vit_split_over_two_ranks_is_one_process(family, tmp_path):
    _, _, _, _, cls_path, shared, _, torch_kw = FAMILIES[family]
    hw = FAMILIES[family][2]
    torch.save(bridged(family)[2], tmp_path / "state.pt")
    args = (cls_path, {**shared, **torch_kw}, str(tmp_path / "state.pt"), images(hw),
            _labels(hw))
    one = tp_zoo_rank(0, 1, 1, *args)
    ranks = run_ranks(tp_zoo_rank, 2, args=(2, *args), timeout=300)
    for got in ranks:
        assert got["split"] == one["split"] and got["split"]
        for g, w in zip(got["logits"], one["logits"]):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        g = np.concatenate([got["grads"][k].ravel() for k in one["grads"]]).astype(np.float64)
        w = np.concatenate([v.ravel() for v in one["grads"].values()]).astype(np.float64)
        assert np.linalg.norm(w) > 0 and np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
        for key in got["split"]:
            assert np.abs(got["grads"][key]).max() > 0, key
