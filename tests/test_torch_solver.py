"""The port's optimizers against the JAX package's optax chains.

Five steps of SGD, Adam and AdamW on the same parameters and gradients:
clip by global norm 1.0 (above it in the first steps, below later), weight
decay, the poly schedule, x0.1 on ``sampling_offsets`` and x
DECODER_LR_COEF (10) on the ``decoder`` parameters, within rtol 1e-5, atol
1e-7. The decoder-label sets: the port's parameters at x DECODER_LR_COEF are
the image, under the ``.pdparams`` key map, of the JAX ``param_labels(...) ==
"decoder"`` set (SETR, DPT); for UperNet and Trans2Seg both are empty. Also
the yamls' AdamW / Adam wiring and ``--resume`` of their state.
"""
from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import emrt_tpu.config as jax_config  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver.lr_scheduler import polynomial_decay as jax_poly  # noqa: E402
from emrt_tpu.solver.optimizer import param_labels  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_zoo import FAMILIES, jax_model, torch_model  # noqa: E402

from emrt_tpu_torch import config as torch_config  # noqa: E402
from emrt_tpu_torch.solver import SGD, Adam, AdamW, get_optimizer, polynomial_decay  # noqa: E402
from emrt_tpu_torch.solver.optimizer import lr_multiplier  # noqa: E402
from emrt_tpu_torch.utils import pdparams  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SETR_YAML = ROOT / "configs" / "setr" / "SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml"
ADAMW_YAML = ROOT / "configs" / "upernet_swin" / "upernet_swin_tiny_512x512_160k_ade20k.yaml"
ADAM_YAML = ROOT / "configs" / "trans2seg" / "Trans2Seg_medium_512x512_80k_trans10kv2.yaml"
_SHAPES = {"encoder/w": (6, 5), "encoder/sampling_offsets/kernel": (5, 4),
           "decoder/w": (4, 3), "decoder/b": (3,)}
COEF = 10.0


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


class _Params(torch.nn.Module):
    """Parameters named as ``_SHAPES`` with '.' for '/'."""

    decoder_lr_prefixes = ("decoder",)

    def __init__(self, flat):
        super().__init__()
        for k, v in flat.items():
            node = self
            *parents, leaf = k.split("/")
            for p in parents:
                if not hasattr(node, p):
                    setattr(node, p, torch.nn.Module())
                node = getattr(node, p)
            setattr(node, leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("name, wd", [("SGD", 1e-4), ("Adam", 1e-2), ("AdamW", 1e-2)])
def test_optimizer_matches_the_optax_chain(name, wd):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in _SHAPES.items()}
             for scale in (3.0, 1.0, 0.3, 0.1, 0.05)]
    cfg = jax_config.get_config(str(SETR_YAML))
    cfg.TRAIN.OPTIMIZER.NAME = name
    cfg.TRAIN.OPTIMIZER.WEIGHT_DECAY = wd
    cfg.TRAIN.OPTIMIZER.GRAD_CLIP = 1.0
    # with 64-bit types, as torch computes its schedule and bias corrections in
    # Python floats: optax in float32 rounds beta2 = 0.999 to 0.99900001, which
    # moves 1 - beta2^t by 1.3e-5 relative and the Adam steps by ~6e-6 (the
    # float32 port stays within 2e-7 of its float64 run, optax 3e-6 from it)
    with jax.enable_x64(True):
        tx = jax_optimizer(cfg, jax_poly(0.01, 8, 0.0, 0.9), params=_tree(init),
                           decoder_lr_coef=COEF, decoder_prefixes=("decoder",))
        params = _tree(init)
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update(_tree(g), state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
        want = _flat(params)

    pcfg = torch_config.get_config(str(SETR_YAML))
    pcfg.merge_from_list(["TRAIN.OPTIMIZER.NAME", name, "TRAIN.OPTIMIZER.WEIGHT_DECAY",
                          str(wd), "TRAIN.OPTIMIZER.GRAD_CLIP", "1.0",
                          "TRAIN.DECODER_LR_COEF", str(COEF)])
    model = _Params(init)
    opt = get_optimizer(pcfg, model, polynomial_decay(0.01, 8, 0.0, 0.9))
    assert type(opt).__name__ == name
    assert [(len(g["params"]), g["lr_mult"]) for g in opt.optimizer.param_groups] == \
        [(1, 1.0), (1, 0.1), (2, COEF)]
    for g in grads:
        for key, p in model.named_parameters():
            p.grad = torch.from_numpy(g[key.replace(".", "/")].copy())
        opt.step()
    assert opt.step_count == 5
    for key, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key.replace(".", "/")],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("family", ["setr_mla", "setr_pup", "setr_naive", "dpt_project",
                                    "upernet_swin", "upernet_focal_a", "trans2seg"])
def test_decoder_lr_sets_are_the_jax_labels_under_the_key_map(family):
    name, encoder, hw = FAMILIES[family][:3]
    jm = jax_model(family)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, hw, hw, 3)))
    flat = _flat(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"]))
    labels = _flat(param_labels(_tree(flat), getattr(jm, "decoder_lr_prefixes", ())))
    pmap = pdparams.build_key_map(flat, name, encoder)[0]
    want = {pdparams._torch_key(pmap[k][0]) for k, lab in labels.items() if lab == "decoder"}
    model = torch_model(family)
    prefixes = getattr(model, "decoder_lr_prefixes", ())
    got = {n for n, _ in model.named_parameters()
           if lr_multiplier(n, prefixes, COEF) == COEF}
    assert got == want
    assert bool(got) == family.startswith(("setr", "dpt"))
    if family == "dpt_project":   # the readout is not the decoder's, in both
        assert not any(n.startswith("head.readout_oper") for n in got)
    assert not any(lab == "lr01" for lab in labels.values())


def test_decoder_lr_coef_one_keeps_one_group():
    model = _Params({k: np.zeros(s, np.float32) for k, s in _SHAPES.items()})
    opt = SGD(model.named_parameters(), lambda s: 0.1, decoder_prefixes=("decoder",),
              decoder_lr_coef=1.0)
    assert [g["lr_mult"] for g in opt.optimizer.param_groups] == [1.0, 0.1]
    assert set(opt.state_dict()) == {"sgd", "step_count"}


@pytest.mark.parametrize("yaml, cls, betas, eps, wd", [
    (ADAMW_YAML, AdamW, (0.9, 0.999), 1e-8, 0.01), (ADAM_YAML, Adam, (0.9, 0.999), 1e-8, 0.0)])
def test_yaml_optimizers_and_resume(yaml, cls, betas, eps, wd):
    """The yaml's optimizer with its betas, eps and decay; its state dict
    restores the moments and the step count, so that the next step after a
    restore equals the next step without one."""
    cfg = torch_config.get_config(str(yaml))
    rng = np.random.default_rng(1)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}

    def run(model, opt, steps, seed):
        g = np.random.default_rng(seed)
        for _ in range(steps):
            for _, p in model.named_parameters():
                p.grad = torch.from_numpy(g.normal(size=p.shape).astype(np.float32))
            opt.step()

    model = _Params(init)
    opt = get_optimizer(cfg, model, polynomial_decay(1e-3, 10))
    assert type(opt) is cls and opt.state_key == cls.__name__.lower()
    torch_opt = opt.optimizer
    assert tuple(torch_opt.defaults["betas"]) == betas and torch_opt.defaults["eps"] == eps
    assert torch_opt.defaults["weight_decay"] == wd
    run(model, opt, 2, 0)
    saved = copy.deepcopy((model.state_dict(), opt.state_dict()))
    run(model, opt, 1, 1)
    want = {k: v.clone() for k, v in model.state_dict().items()}

    other = _Params(init)
    other.load_state_dict(saved[0])
    opt2 = get_optimizer(cfg, other, polynomial_decay(1e-3, 10))
    opt2.load_state_dict(saved[1])
    assert opt2.step_count == 2
    run(other, opt2, 1, 1)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
