"""The port's blockwise causal attention (``ops/blockwise_attention.py``)
against the JAX package's ``lax.scan`` version, forward and grads, at
several block sizes, with key padding (right padding, and rows whose
sequence starts with padding, so they have no valid key), and the error
on a length the blocks do not divide.  The card's path
(``sdpa_attention``: SDPA under a named backend, K/V expanded to the
query heads, the mask and the rows without a key) is held to the plain
twin here through SDPA's math backend, the one the CPU has.

fp32 on the CPU.  Tolerances: outputs 1e-5 and grads 1e-4 of the largest
reference magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.ops.blockwise_attention import blockwise_causal_attention as jax_attn
from project_morpheus_tpu_torch.ops import blockwise_attention as ba


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(seed, B=2, S=64, H=4, KV=2, HD=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[0, 45:] = False   # right padding (pad_collate's)
    mask[1, :20] = False   # rows 0..19 have no valid key
    mask[1, 50:] = False
    return q, k, v, mask, rng.normal(size=(B, S, H, HD)).astype(np.float32)


def _torch_grads(fn, q, k, v, mask, w, **kw):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts, torch.tensor(mask), **kw)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 16), (16, 32), (256, 256)])
def test_twin_matches_jax_forward_and_grads(block_q, block_k):
    q, k, v, mask, w = _inputs(0)

    def jloss(q, k, v):
        out = jax_attn(q, k, v, jnp.asarray(mask), block_q=block_q, block_k=block_k)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = _torch_grads(ba.blockwise_attention_twin, q, k, v, mask, w,
                              block_q=block_q, block_k=block_k)
    assert _rel(out, jout) < 1e-5
    for g, jg in zip(grads, jgrads):
        assert _rel(g, jg) < 1e-4
    # a CPU tensor takes the twin
    got = ba.blockwise_causal_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                        torch.tensor(mask), block_q=block_q, block_k=block_k)
    np.testing.assert_array_equal(got.numpy(), out)


@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 16), (16, 32)])
def test_sdpa_path_matches_twin(block_q, block_k):
    """The card path's glue, run through SDPA's math backend: every row,
    the rows without a valid key included, and the grads."""
    q, k, v, mask, w = _inputs(1)
    kw = dict(block_q=block_q, block_k=block_k)
    out, grads = _torch_grads(ba.blockwise_attention_twin, q, k, v, mask, w, **kw)
    got, got_grads = _torch_grads(ba.sdpa_attention, q, k, v, mask, w, backend="MATH", **kw)
    assert _rel(got, out) < 1e-5
    for g, want in zip(got_grads, grads):
        assert _rel(g, want) < 1e-4


def test_rejects_indivisible_seq():
    q, k, v, mask, _ = _inputs(2, S=48)
    for fn in (ba.blockwise_attention_twin, ba.sdpa_attention):
        with pytest.raises(ValueError, match="divisible"):
            fn(torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(mask),
               block_q=32, block_k=32)
    with pytest.raises(ValueError, match="divisible"):
        jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=32)
