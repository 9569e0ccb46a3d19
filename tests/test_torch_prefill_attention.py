"""The port's chunk-prefill attention (``ops/prefill_attention.py``) and its
batched chunk prefill with device-tensor indices against the JAX package.

- The plain twin of ``prefill_chunk_attention`` (what the CPU runs, and
  what the CUDA kernel is held to on the card) against JAX's
  ``_chunk_streaming_attn`` vmapped over the jobs, as JAX's batched prefill
  calls it: int8 position-major and bf16 head-major histories, one job and
  three on non-adjacent slots at different offsets, garbage written past
  each slot's frontier, history buckets of 64 and 256; and an int8
  history of one kv head at the head shapes of a tensor-parallel rank of
  Orpheus-3B and 1B at tp = 8 (H = 3, HD = 128; H = 4, HD = 64).  fp32
  queries, so the two differ only in summation order: 1e-5 (abs and rel).
- ``llama_prefill_chunk_batch`` with offsets, slots and lengths as int32
  tensors against JAX's ``llama_prefill_chunk_batch``: 1e-3 on the logits,
  1e-2 with both an int8 cache and int8 activations (the tolerances of
  ``test_torch_llama.py``, for the same reasons), and bit for bit against
  the same call given Python lists; also with a rank's one kv head (an
  int8 cache and w8a8 projections, 1e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model import init_llama_params as jax_init
from project_morpheus_tpu.model import llama as jl
from project_morpheus_tpu.model.quant import fuse_layer_weights as jax_fuse
from project_morpheus_tpu.model.quant import quantize_params_int8 as jax_quant
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model import llama as tl
from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy
from project_morpheus_tpu_torch.ops.prefill_attention import (
    LAUNCHES, prefill_chunk_attention)

TWIN_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, KV, G, HD, C = 5, 256, 2, 3, 16, 16


def _history(rng, quant: bool, slots, offsets, KV=KV, HD=HD):
    """One layer of a B-slot cache: random values before each job's
    frontier (offset + C), large finite garbage past it."""
    if quant:
        k = rng.integers(-127, 128, (B, S, KV * HD)).astype(np.int8)
        v = rng.integers(-127, 128, (B, S, KV * HD)).astype(np.int8)
        sc = (rng.random((B, S, 2 * KV)) * 0.02 + 0.002).astype(np.float32)
        for slot, off in zip(slots, offsets):
            k[slot, off + C:], v[slot, off + C:], sc[slot, off + C:] = 127, -127, 1e3
        return {"k": k, "v": v, "scale": sc}
    k = rng.normal(size=(B, KV, S, HD)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, HD)).astype(np.float32)
    for slot, off in zip(slots, offsets):
        k[slot, :, off + C:], v[slot, :, off + C:] = 1e4, -1e4
    # bf16 values, held as fp32 for numpy and JAX
    return {"k": torch.tensor(k).bfloat16().float().numpy(),
            "v": torch.tensor(v).bfloat16().float().numpy()}


def _jax_attention(q, hist, slots, offsets, hist_bucket, KV=KV, G=G, HD=HD):
    """JAX's ``_chunk_streaming_attn`` vmapped over the jobs, on each job's
    history views cut as JAX's batched prefill cuts them."""
    quant = "scale" in hist
    J = len(slots)
    if quant:
        k = np.stack([hist["k"][s, :hist_bucket].reshape(hist_bucket, KV, HD).swapaxes(0, 1)
                      for s in slots])
        v = np.stack([hist["v"][s, :hist_bucket].reshape(hist_bucket, KV, HD).swapaxes(0, 1)
                      for s in slots])
        sc = np.stack([hist["scale"][s, :hist_bucket] for s in slots])
        ks, vs = sc[..., :KV].swapaxes(1, 2), sc[..., KV:].swapaxes(1, 2)
    else:
        k = jnp.asarray(np.stack([hist["k"][s, :, :hist_bucket] for s in slots]), jnp.bfloat16)
        v = jnp.asarray(np.stack([hist["v"][s, :, :hist_bucket] for s in slots]), jnp.bfloat16)
        ks = vs = None
    positions = jnp.asarray(np.asarray(offsets, np.int32)[:, None] + np.arange(C, dtype=np.int32))
    n_live = jnp.asarray(max(offsets) + C)
    qg = jnp.asarray(q.reshape(J, C, KV, G, HD))

    def one(qg_, k_, v_, ks_, vs_, pos_):
        return jl._chunk_streaming_attn(qg_, k_, v_, ks_, vs_, pos_, hist_bucket, n_live=n_live)

    if quant:
        out = jax.vmap(one)(qg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
                            jnp.asarray(vs), positions)
    else:
        out = jax.vmap(lambda a, b, c, d: one(a, b, c, None, None, d))(qg, k, v, positions)
    return np.asarray(out)


@pytest.mark.parametrize("hist_bucket", [64, 256])
@pytest.mark.parametrize("slots", [[2], [4, 1, 3]])
@pytest.mark.parametrize("quant", [True, False])
def test_twin_matches_jax_chunk_streaming_attn(quant, slots, hist_bucket):
    """Each job at its own offset (from 0 to the bucket's last chunk), on
    non-adjacent slots; no kernel launch on the CPU."""
    rng = np.random.default_rng(11 + hist_bucket + len(slots))
    offsets = [hist_bucket - C - 3] if len(slots) == 1 else \
        [0, hist_bucket // 2 - 5, hist_bucket - C]
    hist = _history(rng, quant, slots, offsets)
    q = rng.normal(size=(len(slots), C, KV * G, HD)).astype(np.float32)
    layer = {name: torch.tensor(a) for name, a in hist.items()}
    if not quant:
        layer = {name: t.bfloat16() for name, t in layer.items()}
    launches = LAUNCHES["prefill_chunk_attention"]
    got = prefill_chunk_attention(
        torch.tensor(q), layer, torch.tensor(slots, dtype=torch.int32),
        torch.tensor(offsets, dtype=torch.int32), hist_bucket)
    assert LAUNCHES["prefill_chunk_attention"] == launches
    assert got.dtype == torch.float32 and got.shape == (len(slots), C, KV * G * HD)
    want = _jax_attention(q, hist, slots, offsets, hist_bucket)
    np.testing.assert_allclose(got.numpy(), want, **TWIN_TOL)


@pytest.mark.parametrize("G,HD", [(3, 128), (4, 64)])
def test_twin_matches_jax_at_one_kv_head(G, HD):
    """An int8 history of one kv head (a tp = 8 rank's share of Orpheus-3B,
    H = 3, HD = 128, and of 1B, H = 4, HD = 64): two jobs at their own
    offsets, garbage past each frontier."""
    rng = np.random.default_rng(G * HD)
    slots, offsets, hist_bucket = [3, 0], [0, 256 - C - 5], 256
    hist = _history(rng, True, slots, offsets, KV=1, HD=HD)
    q = rng.normal(size=(len(slots), C, G, HD)).astype(np.float32)
    layer = {name: torch.tensor(a) for name, a in hist.items()}
    got = prefill_chunk_attention(
        torch.tensor(q), layer, torch.tensor(slots, dtype=torch.int32),
        torch.tensor(offsets, dtype=torch.int32), hist_bucket)
    assert got.shape == (len(slots), C, G * HD)
    want = _jax_attention(q, hist, slots, offsets, hist_bucket, KV=1, G=G, HD=HD)
    np.testing.assert_allclose(got.numpy(), want, **TWIN_TOL)


_WEIGHTS = {}


def _weights(kind):
    if kind not in _WEIGHTS:
        p = jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(3), dtype=jnp.float32)
        if kind == "int8_fused":
            p = jax_fuse(jax_quant(p))
        _WEIGHTS[kind] = (p, params_from_jax_numpy(jax.tree.map(np.asarray, p)))
    return _WEIGHTS[kind]


_jax_prefill_batch = jax.jit(jl.llama_prefill_chunk_batch,
                             static_argnames=("cfg", "hist_bucket", "w8a8"))


@pytest.mark.parametrize("quant,w8a8", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_prefill_batch_with_device_indices_matches_jax(quant, w8a8):
    """Two rounds of J = 3 chunks on slots 3, 0, 2 of a 4-slot cache, each
    job at its own offset, the second round padded: device-tensor indices
    against JAX (1e-3; 1e-2 with an int8 cache and w8a8) and against lists
    (equal, logits and cache)."""
    cfg = LlamaConfig.tiny_vocab()
    jp, tp = _weights("int8_fused" if w8a8 else "plain")
    rng = np.random.default_rng(17)
    slots, J, clen = [3, 0, 2], 3, 16
    toks = rng.integers(3, 900, (J, 64)).astype(np.int32)
    jc = jl.init_kv_cache(cfg, 4, 64, jnp.int8 if quant else jnp.float32)
    tc = tl.init_kv_cache(cfg, 4, 64, torch.int8 if quant else torch.float32)
    tc_list = {name: t.clone() for name, t in tc.items()}
    for offs, lens in (([0, 16, 32], [16, 16, 16]), ([16, 32, 48], [16, 9, 12])):
        chunk = np.zeros((J, clen), np.int32)
        for j, (off, n) in enumerate(zip(offs, lens)):
            chunk[j, :n] = toks[j, off:off + n]
        jlog, jc = _jax_prefill_batch(
            jp, jnp.asarray(chunk), cfg, jc, jnp.asarray(offs), jnp.asarray(slots),
            jnp.asarray(lens), hist_bucket=64, w8a8=w8a8)
        i32 = dict(dtype=torch.int32)
        tlog = tl.llama_prefill_chunk_batch(
            tp, torch.tensor(chunk), cfg, tc, torch.tensor(offs, **i32),
            torch.tensor(slots, **i32), torch.tensor(lens, **i32), hist_bucket=64, w8a8=w8a8)
        tol = 1e-2 if quant and w8a8 else 1e-3
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=tol, atol=tol)
        llog = tl.llama_prefill_chunk_batch(tp, torch.tensor(chunk), cfg, tc_list, offs, slots,
                                            lens, hist_bucket=64, w8a8=w8a8)
        assert torch.equal(llog, tlog)
    for name in tc:
        assert torch.equal(tc[name], tc_list[name]), name


def test_prefill_batch_at_one_kv_head_matches_jax():
    """A rank's shapes at tp = 8 (one kv head, three query heads) with an
    int8 cache and w8a8 projections: two rounds of J = 2 chunks, the
    second padded, against JAX's batched prefill (1e-2, as above)."""
    fields = dict(num_heads=3, num_kv_heads=1, head_dim=16)
    cfg = dataclasses.replace(LlamaConfig.tiny_vocab(), **fields)
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny_vocab(), **fields)
    jp = jax_fuse(jax_quant(jax_init(jcfg, jax.random.key(5), dtype=jnp.float32)))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(23)
    slots, J, clen = [2, 0], 2, 16
    toks = rng.integers(3, 900, (J, 32)).astype(np.int32)
    jc = jl.init_kv_cache(jcfg, 3, 64, jnp.int8)
    tc = tl.init_kv_cache(cfg, 3, 64, torch.int8)
    i32 = dict(dtype=torch.int32)
    for offs, lens in (([0, 0], [16, 16]), ([16, 16], [16, 7])):
        chunk = np.zeros((J, clen), np.int32)
        for j, (off, n) in enumerate(zip(offs, lens)):
            chunk[j, :n] = toks[j, off:off + n]
        jlog, jc = _jax_prefill_batch(
            jp, jnp.asarray(chunk), jcfg, jc, jnp.asarray(offs), jnp.asarray(slots),
            jnp.asarray(lens), hist_bucket=64, w8a8=True)
        tlog = tl.llama_prefill_chunk_batch(
            tp, torch.tensor(chunk), cfg, tc, torch.tensor(offs, **i32),
            torch.tensor(slots, **i32), torch.tensor(lens, **i32), hist_bucket=64, w8a8=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-2, atol=1e-2)
