"""Tensor parallelism of the port (``parallel/tensor.py``, PARALLEL.MODEL) on
gloo ranks on the CPU (``parallel.launch``; the ranks' halves are in
``test_torch_tensor_parallel_ranks.py``):

- the rule: the port splits exactly the parameters the JAX package's
  ``tp_rule`` splits in the tiny EMRT-R50 (under the ``.pdparams`` key map),
  each rank's shard is the one ``tp_shard_params`` gives its device (through
  ``state_dict_from_flax``), and gathering the shards gives the whole state;
- ``check_parallel`` refuses SPATIAL 2 with MODEL 2 for a ViT EMRT (its
  transformer backbone is not sharded by rows) and accepts it for the
  EMRT-R50 on four ranks, and refuses a MODEL that does not divide the
  world and one that does not divide the heads or the FFN's width;
- one train step of the tiny EMRT-R50 on four ranks as dp2 x tp2 against the
  JAX package's step on a ``data=2, model=2`` mesh with ``tp_shard_params``,
  from the same bridged weights and batch as the DP test, with that test's
  bounds: the loss 1e-5 relative; each parameter's update within 0.1 x that
  tensor's largest update + 1e-2 x the model's largest + two float32
  spacings of the tensor's largest value + 1e-10; BatchNorm running
  statistics 1e-4 x the tensor's max. The four ranks' gathered states and
  the replicated parameters of each rank's own model are bit for bit equal.
  Closer: the learned reference points' gradients (the SGD momentum) within
  ``REFERENCE_GRAD_RTOL`` of their largest entry, and each replicated
  gradient's spread over the model group, before the optimizer gives it
  rank 0's, within 1e-6 of its largest entry: summation order, not a share
  of the heads;
- dp1 x tp2 against one process of the port, with those closer checks:
  with dropout 0.1 the loss
  within 1e-5 relative (the split sites draw the full-width masks), and the
  clip (at 0.05, a third of the batch's gradient norm): the norm before it
  within 1e-5 relative and the updates within the bounds above;
- the clip of a model whose gradient lies mostly in the split parameters
  takes the whole model's norm over the model group.

The data group's semantics and the CLIs under tensor parallelism are in
``test_torch_tensor_parallel_train.py``, the zoo's ViT attentions in
``test_torch_tensor_parallel_zoo.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.parallel import (batch_sharding, create_mesh, replicated,  # noqa: E402
                               tp_rule, tp_shard_params)
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_emrt import bridged_state_dict, bridged_weights, tiny_jax_emrt  # noqa: E402
from test_torch_parallel_ranks import FLAGSHIP, SMOKE  # noqa: E402
from test_torch_parallel_train import _batch  # noqa: E402
from test_torch_tensor_parallel_ranks import (LEARNED_REFERENCE, tp_clip_rank,  # noqa: E402
                                              tp_train_step_rank)

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.models.deformable_transformer import EncoderLayer  # noqa: E402
from emrt_tpu_torch.models.emrt import EMRT  # noqa: E402
from emrt_tpu_torch.parallel import check_parallel  # noqa: E402
from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.parallel.tensor import (gather_state_dict, shard_state_dict,  # noqa: E402
                                            splits_of)
from emrt_tpu_torch.utils.pdparams import build_key_map, state_dict_from_flax  # noqa: E402
from emrt_tpu_torch.utils.pdparams import _torch_key  # noqa: E402

torch.set_num_threads(1)


def _tiny_torch_emrt():
    return EMRT(num_classes=6, num_encoder_layers=1, num_decoder_layers=1)


def _jax_split_paths(params):
    """{flax path: PartitionSpec} of the leaves ``tp_rule`` splits."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tp_rule(path, leaf)
        if any(axis is not None for axis in spec):
            out["/".join(str(getattr(k, "key", k)) for k in path)] = spec
    return out


def test_the_rule_splits_tp_rules_parameters_into_the_shards_of_each_device():
    _, params, stats = bridged_weights()
    flat = _flat(params)
    jax_split = _jax_split_paths(params)
    pmap, _, _ = build_key_map(flat, "EMRT", "resnet50")
    want = {_torch_key(pmap[path][0]) for path in jax_split}
    splits = splits_of(_tiny_torch_emrt())
    # value_proj, output_proj, linear1, linear2 in each layer; the MHA's fused
    # q/k/v kernels and biases and out_proj
    assert set(splits) == want and len(want) == 11

    full = bridged_state_dict()
    mesh = create_mesh(data=1, model=2, devices=jax.devices()[:2])
    for m in range(2):
        # device m's shard of each split flax leaf, whole leaves elsewhere
        shard_m = {}
        for path, spec in jax_split.items():
            placed = jax.device_put(flat[path], NamedSharding(mesh, spec))
            shard_m[path] = next(np.asarray(s.data) for s in placed.addressable_shards
                                 if s.device == mesh.devices[0, m, 0])
        got = state_dict_from_flax({**flat, **shard_m}, _flat(stats))
        mine = shard_state_dict(full, m, 2, splits)
        for key in splits:
            np.testing.assert_array_equal(mine[key].numpy(), got[key].numpy(), err_msg=key)
        assert mine["model.decoder.layers.0.self_attn.in_proj_weight"].shape == (384, 256)
    for t in (2, 4):
        joined = gather_state_dict([shard_state_dict(full, m, t, splits) for m in range(t)],
                                   splits)
        assert joined.keys() == full.keys()
        for key, value in full.items():
            assert torch.equal(joined[key], value), key


def _tiny_vit_emrt():
    with torch.device("meta"):
        return EMRT(num_classes=6, backbone="vit", num_encoder_layers=1, num_decoder_layers=1,
                    vit_hidden=32, vit_layers=4, vit_heads=2, vit_out_indices=(0, 1, 2, 3),
                    img_size=(64, 64))


@pytest.mark.parametrize("overrides, world, exc, match", [
    ({"SPATIAL": 2, "MODEL": 2}, 4, NotImplementedError,
     "transformer backbone .*ROADMAP.md queue 1, item 4"),
    ({"MODEL": 3}, 4, ValueError, "PARALLEL.MODEL 3 does not divide the 4"),
    ({"MODEL": 2, "DATA": 1}, 4, ValueError, "PARALLEL.DATA 1 x PARALLEL.MODEL 2"),
    ({"MODEL": 3}, 3, ValueError, "the 8 heads of model.encoder.layers.0.self_attn"),
    ({"MODEL": 16}, 16, ValueError, "does not divide the 8 heads of model.encoder"),
], ids=["spatial", "world", "data", "heads", "heads-16"])
def test_check_parallel_refuses_spatial_and_uneven_splits(overrides, world, exc, match):
    cfg = get_config(str(SMOKE))
    for key, value in overrides.items():
        setattr(cfg.PARALLEL, key, value)
    with pytest.raises(exc, match=match):
        check_parallel(cfg, world, _tiny_vit_emrt() if "SPATIAL" in overrides
                       else _tiny_torch_emrt())


def test_check_parallel_accepts_dp_x_tp_and_refuses_an_uneven_ffn():
    cfg = get_config(str(SMOKE))
    cfg.PARALLEL.MODEL = 2
    check_parallel(cfg, 4, _tiny_torch_emrt())
    cfg.PARALLEL.SPATIAL = 2                   # dp1 x tp2 x sp2 of the EMRT-R50
    check_parallel(cfg, 4, _tiny_torch_emrt())
    cfg.PARALLEL.SPATIAL = 1
    cfg.PARALLEL.DATA = 2
    check_parallel(cfg, 4)
    cfg.PARALLEL.MODEL, cfg.PARALLEL.DATA = 8, -1
    with pytest.raises(ValueError, match="PARALLEL.MODEL 8 does not divide the 1020 FFN "
                                         "hidden units of EncoderLayer$"):
        check_parallel(cfg, 8, EncoderLayer(256, 8, 1020))


def _assert_update_bounds(got, want, before):
    """The DP test's bounds on each parameter's update and statistics
    (``got`` and ``want`` map names to arrays or tensors)."""
    as_double = lambda d: {k: torch.as_tensor(np.asarray(v)).double() for k, v in d.items()}  # noqa: E731
    got, want, before = as_double(got), as_double(want), as_double(before)
    want = {k: w for k, w in want.items() if "num_batches_tracked" not in k}
    largest = max((w - before[k]).abs().max() for k, w in want.items() if "running" not in k)
    n_params = n_stats = 0
    for key, w in want.items():
        g, b = got[key], before[key]
        if "running" in key:
            n_stats += 1
            assert (g - w).abs().max() <= 1e-4 * w.abs().max(), key
        else:
            n_params += 1
            ulp = float(np.spacing(np.float32(w.abs().max())))
            bound = 0.1 * (w - b).abs().max() + 1e-2 * largest + 2 * ulp + 1e-10
            assert (g - w).abs().max() <= bound, key
    assert n_params > 250 and n_stats > 100


# the learned reference points' gradients (each rank's SGD momentum after
# the step, less the weight decay's term), relative to the gradient's
# largest entry: the DP bounds above allow a tenth of a tensor's update,
# these train at a tenth of the lr and their first update is a few float32
# spacings of the weights, so a rank that kept only its heads' share of
# their gradient (~1/2 of it at tp2) would pass those. Against the JAX step
# the two frameworks' sums differ in order, which BatchNorm on batch
# statistics amplifies (7.6e-3 read); against one process of the port, the
# same sums split in two (0 read)
REFERENCE_GRAD_RTOL = {"jax": 5e-2, "port": 1e-4}
# a replicated gradient's spread over the model group before the optimizer
# gives it rank 0's (relative to its largest entry): summation order alone
SPREAD_TOL = 1e-6


def _assert_reference_gradients(got, want, before, rtol):
    weight_decay = float(get_config(str(FLAGSHIP)).TRAIN.OPTIMIZER.WEIGHT_DECAY)
    for key in LEARNED_REFERENCE:
        g, w, b = (torch.as_tensor(np.asarray(d[key])).double() for d in (got, want, before))
        grad = (w - weight_decay * b).abs().max()
        assert grad > 0 and (g - w).abs().max() <= rtol * grad, key


def _assert_spread(spread):
    assert len(spread) > 250 and set(LEARNED_REFERENCE) <= set(spread)
    worst = max(spread, key=spread.get)
    assert spread[worst] <= SPREAD_TOL, (worst, spread[worst])


def test_tiny_emrt_dp2_x_tp2_train_step_matches_the_jax_tp_sharded_step(monkeypatch, tmp_path):
    image, label = _batch()
    _, params, stats = bridged_weights()

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mesh = create_mesh(data=2, model=2, devices=jax.devices()[:4])
    cfg = jax_get_config(str(FLAGSHIP))
    sharded = tp_shard_params(params, mesh)
    k = sharded["encoder_decoder"]["encoder_layer0"]["linear1"]["kernel"]
    assert len(k.addressable_shards[0].data.shape) == 2 and \
        k.addressable_shards[0].data.shape[1] == k.shape[1] // 2
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=sharded)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=sharded,
                       batch_stats=jax.device_put(stats, replicated(mesh)),
                       opt_state=tx.init(sharded), tx=tx)
    batch = jax.device_put({"image": image, "label": label}, batch_sharding(mesh))
    step = jax_make_train_step(tiny_jax_emrt(), jax_loss(cfg), donate=False)
    new_state, metrics = step(state, batch, jax.random.key(0))
    want = state_dict_from_flax(_flat(jax.device_get(new_state.params)),
                                _flat(jax.device_get(new_state.batch_stats)))
    trace = next(s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)).trace
    momentum = state_dict_from_flax(_flat(jax.device_get(trace)), _flat(stats))

    before = bridged_state_dict()
    torch.save(before, tmp_path / "bridged.pt")
    ranks = run_ranks(tp_train_step_rank, 4,
                      args=(2, str(tmp_path / "bridged.pt"), image, label, 0.0), timeout=600)
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
        assert got["steps"] == 1
    for r in ranks[1:]:
        for key, value in ranks[0]["state"].items():
            np.testing.assert_array_equal(value, r["state"][key], err_msg=key)
        for key, value in ranks[0]["replicated"].items():
            np.testing.assert_array_equal(value, r["replicated"][key], err_msg=key)
    got = ranks[0]["state"]
    assert set(want) <= set(got)
    assert all(got[k].shape == tuple(v.shape) for k, v in before.items())   # whole tensors
    _assert_update_bounds(got, want, before)
    for r in ranks:
        _assert_reference_gradients(r["momentum"], momentum, before,
                                    REFERENCE_GRAD_RTOL["jax"])
        _assert_spread(r["spread"])


# the clip case clips at 0.05, a third of this batch's gradient norm (0.156
# with these weights, below the flagship's 1.0), so every update is scaled
@pytest.mark.parametrize("dropout, clip", [(0.1, None), (0.0, 0.05)], ids=["dropout", "clip"])
def test_dp1_x_tp2_step_is_one_processs_step(dropout, clip, tmp_path):
    image, label = _batch()
    before = bridged_state_dict()
    torch.save(before, tmp_path / "bridged.pt")
    args = (str(tmp_path / "bridged.pt"), image, label, dropout, clip)
    one = tp_train_step_rank(0, 1, 1, *args)
    ranks = run_ranks(tp_train_step_rank, 2, args=(2, *args), timeout=600)
    for got in ranks:
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        # the norm before the clip is the whole model's, not the rank's
        np.testing.assert_allclose(got["norm"], one["norm"], rtol=1e-5)
        assert clip is None or got["norm"] > 2 * clip
        _assert_spread(got["spread"])
        _assert_reference_gradients(got["momentum"], one["momentum"], before,
                                    REFERENCE_GRAD_RTOL["port"])
    for key, value in ranks[0]["replicated"].items():
        np.testing.assert_array_equal(value, ranks[1]["replicated"][key], err_msg=key)
    _assert_update_bounds(ranks[0]["state"], one["state"], before)


def test_the_clip_takes_the_whole_models_norm_over_the_model_group():
    """A small deformable encoder-decoder whose gradient lies mostly in the
    split parameters (scaled so), clipped to a tenth of its norm: the dp1 x
    tp2 step is
    one process's (summation order aside: updates within 1e-4 of the
    tensor's and the model's largest update and two float32 spacings), which a norm over the rank's shards alone would miss
    by the share of the other rank's."""
    clip = tp_clip_rank(0, 1, 1, 1e30)["norm"] / 10     # the norm, unclipped
    one = tp_clip_rank(0, 1, 1, clip)
    assert one["share"] > 0.5
    before = tp_clip_rank(0, 1, 1, 1e-30)["state"]     # the update clipped to nothing
    ranks = run_ranks(tp_clip_rank, 2, args=(2, clip), timeout=300)
    largest = max(np.abs(w - before[k]).max() for k, w in one["state"].items())
    for got in ranks:
        np.testing.assert_allclose(got["norm"], one["norm"], rtol=1e-6)
        for key, w in one["state"].items():
            update = np.abs(w - before[key]).max()
            ulp = np.spacing(np.float32(np.abs(w).max()))
            np.testing.assert_allclose(got["state"][key], w, rtol=0,
                                       atol=1e-4 * (update + largest) + 2 * ulp, err_msg=key)
