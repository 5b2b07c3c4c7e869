"""The deformable transformer's learned position embedding
(``position_embed_type="learned"``) against the JAX package's.

- ``LearnedPositionEmbedding`` from the same tables: exactly equal (a
  gather and a concatenation), x first, and a map larger than the tables
  raises in both;
- the encoder-decoder of ``tests/test_models.py::test_learned_position_embedding_encdec``
  (1 encoder and 1 decoder layer, 256 channels, levels 8^2, 4^2, 2^2) with
  learned tables and the attentions' zero-initialised query projections
  drawn, its flax parameters carried across by
  ``state_dict_from_flax``: the decoder's output and the encoder's memory
  within 1e-4 x their largest value (float32 sums in another order through
  two layers), and the sine transformer's memory apart from it.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from emrt_tpu.models.deformable_transformer import EncoderDecoder as JaxEncoderDecoder  # noqa: E402
from emrt_tpu.models.position_encoding import \
    LearnedPositionEmbedding as JaxLearned  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_emrt import load_checked  # noqa: E402

from emrt_tpu_torch.models.deformable_transformer import EncoderDecoder  # noqa: E402
from emrt_tpu_torch.models.position_encoding import LearnedPositionEmbedding  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)
LEVELS = ((8, 8), (4, 4), (2, 2))
RTOL = 1e-4


def _jax_tables(num_pos_feats=16, num_embeddings=50):
    module = JaxLearned(num_pos_feats, num_embeddings)
    return module, module.init(jax.random.key(0), 3, 3)


@pytest.mark.parametrize("hw", [(8, 8), (3, 7), (50, 1), (50, 50)])
def test_learned_table_is_the_jax_table(hw):
    module, variables = _jax_tables()
    want = np.asarray(module.apply(variables, *hw))
    port = LearnedPositionEmbedding(16, 50)
    tables = variables["params"]
    port.row_embed.weight.data = torch.from_numpy(np.array(tables["row_embed"]["embedding"]))
    port.col_embed.weight.data = torch.from_numpy(np.array(tables["col_embed"]["embedding"]))
    got = port(*hw)
    assert got.shape == want.shape == (hw[0] * hw[1], 32)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # x first: position (y, x) = row y * w + x holds col[x], then row[y]
    h, w = hw
    y, x = h - 1, w - 1
    np.testing.assert_array_equal(got[y * w + x, :16].detach().numpy(),
                                  np.asarray(tables["col_embed"]["embedding"])[x])


@pytest.mark.parametrize("hw", [(51, 8), (8, 51)])
def test_a_map_larger_than_the_tables_raises_in_both(hw):
    module, variables = _jax_tables()
    with pytest.raises(ValueError, match="table holds 50"):
        module.apply(variables, *hw)
    with pytest.raises(ValueError, match="table holds 50"):
        LearnedPositionEmbedding(16, 50)(*hw)


def test_the_transformer_refuses_another_embedding_type():
    with pytest.raises(ValueError, match="position_embed_type"):
        EncoderDecoder([256] * 3, position_embed_type="cosine")


def _inputs():
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(2, h, w, 256)).astype(np.float32) for h, w in LEVELS]
    psp = rng.normal(size=(2, 110, 256)).astype(np.float32)
    return feats, psp


def _live_queries(variables, scale=0.02):
    """The deformable attentions' sampling-offset and attention-weight
    kernels, zeros at init (so that the queries, and with them the position
    embedding, reach nothing), to N(0, ``scale``)."""
    rng = np.random.default_rng(3)
    flat = traverse_util.flatten_dict(variables["params"], sep="/")
    for key, value in flat.items():
        if key.endswith(("sampling_offsets/kernel", "attention_weights/kernel")):
            flat[key] = jnp.asarray(rng.normal(scale=scale, size=value.shape), value.dtype)
    return {**variables, "params": traverse_util.unflatten_dict(flat, sep="/")}


def _port(position_embed_type, state):
    model = EncoderDecoder([256] * 3, num_encoder_layers=1, num_decoder_layers=1,
                           position_embed_type=position_embed_type)
    return load_checked(model, state, prefix="model.")


def test_learned_transformer_matches_jax():
    feats, psp = _inputs()
    encdec = JaxEncoderDecoder(num_encoder_layers=1, num_decoder_layers=1,
                               position_embed_type="learned")
    variables = _live_queries(encdec.init(jax.random.key(0), [jnp.asarray(f) for f in feats],
                                          jnp.asarray(psp)))
    want_hs, want_mem = encdec.apply(variables, [jnp.asarray(f) for f in feats], jnp.asarray(psp))
    flat = {f"encoder_decoder/{k}": v for k, v in _flat(variables["params"]).items()}
    state = state_dict_from_flax(flat, {})
    for table in ("row_embed", "col_embed"):
        key = f"model.position_embedding.{table}.weight"
        np.testing.assert_array_equal(
            state[key].numpy(), np.asarray(variables["params"]["position_embedding"][table]
                                           ["embedding"]))
    x = [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats]
    with torch.no_grad():
        hs, mem = _port("learned", state)(x, torch.from_numpy(psp))
        _, sine_mem = _port("sine", {k: v for k, v in state.items()
                                    if "position_embedding" not in k})(x, torch.from_numpy(psp))
    for got, want in ((hs, want_hs), (mem, want_mem)):
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= RTOL * scale
    # the tables reach the output: the sine embedding gives another memory
    apart = np.abs(sine_mem.numpy() - np.asarray(want_mem)).max() / np.abs(np.asarray(want_mem)).max()
    assert apart > 100 * RTOL
