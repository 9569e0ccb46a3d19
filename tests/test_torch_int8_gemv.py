"""The int8 weight-only GEMV's plain twin (the dequant-then-matmul of the
port's ``model/quant.py``) against the JAX package's ``matmul_maybe_quant``
and ``tied_lm_head_logits`` on the same int8 weights, at M = 1 and 8 rows.

fp32 on both sides: the two differ only in summation order, so outputs
agree to 1e-5 relative (and 1e-5 absolute).  On the CPU the wrapper
``ops.int8_gemv.int8_gemv`` runs that twin; the kernel itself is held
against it on the card (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import quant as jq
from project_morpheus_tpu_torch.model import quant as tq
from project_morpheus_tpu_torch.ops import int8_gemv as ig

TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    scale = rng.uniform(1e-3, 2e-2, N).astype(np.float32)
    return h, q, scale


@pytest.mark.parametrize("M", [1, 8])
def test_projection_twin_matches_jax(M):
    h, q, scale = _operands(M, 96, 80, M)
    want = np.asarray(jq.matmul_maybe_quant(jnp.asarray(h), {"q": jnp.asarray(q),
                                                             "scale": jnp.asarray(scale)}))
    leaf = {"q": torch.tensor(q), "scale": torch.tensor(scale)}
    got = tq.matmul_maybe_quant(torch.tensor(h), leaf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ig.reset_launch_counts()
    via = ig.int8_gemv(torch.tensor(h), leaf["q"], leaf["scale"])
    np.testing.assert_array_equal(via.numpy(), got.numpy())
    assert ig.LAUNCHES["int8_gemv"] == 0  # the CPU twin is no launch


@pytest.mark.parametrize("M", [1, 8])
def test_tied_lm_head_twin_matches_jax(M):
    h, q, scale = _operands(M, 64, 200, 10 + M)
    table = q.T.copy()  # (vocab, D), K contiguous
    want = np.asarray(jq.tied_lm_head_logits(
        jnp.asarray(h), {"q": jnp.asarray(table), "scale": jnp.asarray(scale)}))
    emb = {"q": torch.tensor(table), "scale": torch.tensor(scale)}
    got = tq.tied_lm_head_logits(torch.tensor(h), emb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    via = ig.int8_gemv(torch.tensor(h), emb["q"], emb["scale"], k_major=True)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("K,N", [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072),
                                 (256, 1280), (8192, 40960)])
def test_k_splits_cover_the_grid(K, N, sms):
    """The (K, N) launch splits K over a cluster of 1, 2, 4 or 8 blocks:
    the largest whose grid has at most one block for each of the card's
    SMs (114 on the PCIe H100, 132 on the SXM), every block with at least
    one 128-row stage of K."""
    s, tiles, stages = ig.k_splits(K, N, sms), -(-N // 128), -(-K // 128)
    assert s in (1, 2, 4, 8) and s <= stages
    assert s == 1 or tiles * s <= sms
    assert s == 8 or 2 * s > stages or tiles * 2 * s > sms


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("N", [1, 64, 1000, 157184])
def test_nk_blocks_cover_the_table(N, sms):
    """The (N, K) launch runs one persistent block a SM, never more blocks
    than 64-row tiles of the table."""
    b = ig.nk_blocks(N, sms)
    assert 1 <= b <= sms and b <= -(-N // 64)
    assert b == sms or b == -(-N // 64)
