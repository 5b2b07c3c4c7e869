"""The port's DPT (each readout) and Trans2Seg against the JAX package's.

The cases and bounds of ``test_torch_zoo.py`` (eval logits, train-mode
loss, eval-mode gradients); DPT's two ConvTranspose resamples go through
the JAX converter's flip and ``state_dict_from_flax``'s inverse of it.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from test_torch_zoo import cases, check_family  # noqa: E402


@pytest.mark.parametrize("family, check", cases(("dpt_project", "dpt_add", "dpt_ignore",
                                                 "trans2seg")))
def test_family_matches_jax(family, check):
    check_family(family, check)


def test_trans2seg_head_major_reshape():
    """fc_q's [b, n_class, C] output is read head-major as [b, heads,
    n_class, head_dim]: swapping in the per-class split changes the logits."""
    from emrt_tpu_torch.models.trans2seg import AttentionDecoder
    torch.manual_seed(0)
    dec = AttentionDecoder(16, 4).eval()
    q, x = torch.randn(2, 6, 16), torch.randn(2, 10, 16)
    maps, out = dec(q, x)
    qh = dec.fc_q(q).reshape(2, 4, 6, 4)
    k, v = dec.fc_kv(x).view(2, 10, 2, 4, 4).unbind(2)
    logits = torch.einsum("bhqd,bkhd->bhqk", qh, k) * 0.5
    torch.testing.assert_close(maps, logits.transpose(1, 2))
    want = dec.proj(torch.einsum("bhqk,bkhd->bhqd", logits.softmax(-1), v).reshape(2, 6, 16))
    torch.testing.assert_close(out, want)
