"""The port's decoder (project_morpheus_tpu_torch.model.llama) against the
JAX package's: helpers, chunked prefill and the decode step in its three
attention branches, with plain and int8 weights carried across.

Everything runs in fp32 on the CPU; the two packages then differ only in
summation order, so logits agree to 1e-3 (abs and rel) and caches to 1e-4,
except where a quantisation step rounds a value on a half-step the other
way, which the int8 cases bound separately (see each test)."""
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

TOL = dict(rtol=1e-4, atol=1e-4)
_jax_prefill = jax.jit(jl.llama_prefill_chunk, static_argnames=("cfg", "hist_bucket", "w8a8"))
_jax_decode = jax.jit(jl.llama_decode_step, static_argnames=("cfg", "attn_impl", "bucket"))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.tiny_vocab()


_WEIGHTS = {}


def _weights(kind):
    """JAX params of one kind and their carried-across torch copy."""
    if kind not in _WEIGHTS:
        cfg = JaxLlamaConfig.tiny_vocab()
        p = jax_init(cfg, jax.random.key(3), dtype=jnp.float32)
        if kind != "plain":
            p = jax_quant(p)
        if kind == "int8_fused":
            p = jax_fuse(p)
        _WEIGHTS[kind] = (p, params_from_jax_numpy(jax.tree.map(np.asarray, p)))
    return _WEIGHTS[kind]


def test_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.rmsnorm(torch.tensor(x), torch.tensor(scale), 1e-5)),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5)), **TOL)
    for c in (LlamaConfig.tiny(), LlamaConfig.orpheus_3b()):
        np.testing.assert_allclose(_np(tl.rope_inv_freqs(c)), np.asarray(jl.rope_inv_freqs(c)),
                                   rtol=1e-6)
    c = LlamaConfig.orpheus_3b()
    pos = rng.integers(0, 8192, (2, 5)).astype(np.int32)
    xr = rng.normal(size=(2, 5, 3, 128)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.apply_rope(torch.tensor(xr), torch.tensor(pos), tl.rope_inv_freqs(c))),
        np.asarray(jl.apply_rope(jnp.asarray(xr), jnp.asarray(pos), jl.rope_inv_freqs(c))),
        rtol=1e-4, atol=1e-3)  # angles up to 8192 rad: cos/sin of large args
    q_t, s_t = tl.quantize_kv(torch.tensor(x))
    q_j, s_j = jl.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-7)


def _caches(cfg, B, S, quant):
    jc = jl.init_kv_cache(cfg, B, S, jnp.int8 if quant else jnp.float32)
    tc = tl.init_kv_cache(cfg, B, S, torch.int8 if quant else torch.float32)
    return jc, tc


def _assert_cache_close(jc, tc):
    for name in jc:
        a, b = np.asarray(jc[name]), tc[name].numpy()
        if a.dtype == np.int8:
            # a value on a rounding half-step may land one step apart
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind,quant,w8a8", [
    ("plain", False, False), ("plain", True, False), ("int8", False, True),
    ("int8_fused", True, True), ("int8_fused", True, False),
])
def test_prefill_chunks_match_jax(cfg, kind, quant, w8a8):
    """Two chunks (the second attends to the first through the cache)
    into lane 1 of a 2-slot cache: logits and written cache agree."""
    jp, tp = _weights(kind)
    rng = np.random.default_rng(1)
    toks = rng.integers(3, 900, 40).astype(np.int32)
    jc, tc = _caches(cfg, 2, 64, quant)
    for off, clen, length in ((0, 24, 24), (24, 32, 16)):
        chunk = np.zeros(clen, np.int32)
        chunk[:length] = toks[off:off + length]
        jlog, jc = _jax_prefill(
            jp, jnp.asarray(chunk), cfg, jc, jnp.asarray(off), jnp.asarray(1),
            jnp.asarray(length), hist_bucket=64, w8a8=w8a8)
        tlog = tl.llama_prefill_chunk(tp, torch.tensor(chunk), cfg, tc, off, 1, length,
                                      hist_bucket=64, w8a8=w8a8)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-3, atol=1e-3)
    _assert_cache_close(jc, tc)


@pytest.mark.parametrize("kind,attn,quant", [
    ("plain", "dense", False), ("plain", "dense", True), ("plain", "kernel", False),
    ("plain", "kernel", True), ("int8_fused", "dense", True),
    ("int8_fused", "kernel", True), ("int8", "kernel", False),
])
def test_decode_steps_match_jax(cfg, kind, attn, quant):
    """Prefill two slots, then three decode steps (one slot inactive on the
    last) in the dense and kernel-twin branches; each port branch is held
    against its own JAX counterpart ("pallas" for the kernel)."""
    jp, tp = _weights(kind)
    rng = np.random.default_rng(2)
    B, S = 2, 64
    jc, tc = _caches(cfg, B, S, quant)
    lens = [9, 5]
    for b, n in enumerate(lens):
        chunk = rng.integers(3, 900, 16).astype(np.int32)
        _, jc = _jax_prefill(jp, jnp.asarray(chunk), cfg, jc, jnp.asarray(0),
                             jnp.asarray(b), jnp.asarray(n), hist_bucket=64)
        tl.llama_prefill_chunk(tp, torch.tensor(chunk), cfg, tc, 0, b, n, hist_bucket=64)
    lengths = np.asarray(lens, np.int32)
    jimpl = "pallas" if attn == "kernel" else "dense"
    for step in range(3):
        nxt = rng.integers(3, 900, B).astype(np.int32)
        active = np.asarray([True, step < 2])
        jlog, jc = _jax_decode(
            jp, jnp.asarray(nxt), cfg, jc, jnp.asarray(lengths), active=jnp.asarray(active),
            attn_impl=jimpl, bucket=32)
        tlog = tl.llama_decode_step(
            tp, torch.tensor(nxt), cfg, tc, torch.tensor(lengths), active=torch.tensor(active),
            attn_impl=attn, bucket=32)
        # the dense int8 branch requantises q and p: a half-step rounding
        # difference moves a logit by ~1e-3 of its scale
        tol = dict(rtol=2e-3, atol=2e-3) if quant and attn == "dense" else dict(rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
        lengths = lengths + active
    _assert_cache_close(jc, tc)


@pytest.mark.parametrize("kv_heads", [4, 1])  # G = 1 (SmolLM2's MHA) and G = 4 (Mistral's)
def test_kernel_branch_matches_dense_in_bf16(kv_heads):
    """bf16 weights and cache, as served: the kernel branch (its twin on the
    CPU: P in fp32) against the dense branch (P rounded to bf16 before
    P.V), each on its own copy of a random cache, three steps, lanes at
    lengths 0-130 and one inactive on the last step.  Active lanes' logits
    agree within 4e-2 of the largest |logit|: the dense branch's bf16 P and
    its knock-on roundings of the bf16 activations (measured 1.0-2.4%; a
    kernel that misses the newest position is off by over 100%)."""
    cfg = LlamaConfig(vocab_size=1024, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=kv_heads, head_dim=16, max_seq_len=256,
                      rope_scaling_factor=1.0)
    params = tl.init_llama_params(cfg, 5, "cpu", torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    B, S = 4, 256
    cache = tl.init_kv_cache(cfg, B, S, torch.bfloat16, "cpu")
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g).to(torch.bfloat16))
    caches = {a: {n: t.clone() for n, t in cache.items()} for a in ("dense", "kernel")}
    lengths = torch.tensor([40, 3, 130, 0], dtype=torch.int32)
    for step in range(3):
        toks = torch.randint(3, 1000, (B,), generator=g)
        active = torch.tensor([True, True, step < 2, True])
        out = {a: tl.llama_decode_step(params, toks, cfg, c, lengths, active=active,
                                       attn_impl=a, bucket=S)
               for a, c in caches.items()}
        scale = out["dense"][active].abs().max()
        assert torch.all((out["kernel"] - out["dense"])[active].abs() <= 4e-2 * scale)
        assert torch.all(out["kernel"][~active] == 0)
        lengths = lengths + active.int()


_jax_prefill_batch = jax.jit(jl.llama_prefill_chunk_batch,
                             static_argnames=("cfg", "hist_bucket", "w8a8"))


@pytest.mark.parametrize("quant,w8a8", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_prefill_chunk_batch_matches_jax_and_sequential(cfg, quant, w8a8):
    """Two lockstep rounds of J = 3 chunks (slots 2, 0, 3 of a 4-slot cache,
    the second round padded): logits and cache against JAX's
    ``llama_prefill_chunk_batch`` (1e-3, as the single-chunk test; 1e-2 with
    both int8 activations and an int8 cache, where a value on a rounding
    half-step of either quantiser lands one step apart and moves a row's
    logits by up to ~7e-3, as the single-chunk entries of both packages do
    on these inputs), and against J sequential port calls (1e-5: the
    batched projections only change the summation order of the CPU
    matmuls)."""
    jp, tp = _weights("int8_fused" if w8a8 else "plain")
    rng = np.random.default_rng(7)
    slots, J, C = [2, 0, 3], 3, 16
    toks = rng.integers(3, 900, (J, 2 * C)).astype(np.int32)
    jc, tc = _caches(cfg, 4, 64, quant)
    _, tc_seq = _caches(cfg, 4, 64, quant)
    for off, lens in ((0, [C] * J), (C, [16, 9, 12])):
        chunk = np.zeros((J, C), np.int32)
        for j, n in enumerate(lens):
            chunk[j, :n] = toks[j, off:off + n]
        jlog, jc = _jax_prefill_batch(
            jp, jnp.asarray(chunk), cfg, jc, jnp.asarray([off] * J), jnp.asarray(slots),
            jnp.asarray(lens), hist_bucket=64, w8a8=w8a8)
        tlog = tl.llama_prefill_chunk_batch(tp, torch.tensor(chunk), cfg, tc, [off] * J, slots,
                                            lens, hist_bucket=64, w8a8=w8a8)
        tol = 1e-2 if quant and w8a8 else 1e-3
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=tol, atol=tol)
        seq = torch.stack([tl.llama_prefill_chunk(tp, torch.tensor(chunk[j]), cfg, tc_seq, off,
                                                  slots[j], lens[j], hist_bucket=64, w8a8=w8a8)
                           for j in range(J)])
        np.testing.assert_allclose(tlog.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)
    if quant and w8a8:
        # a flipped activation step reaches the later layers' K/V: a few
        # int8 steps, and scales ~1% apart, in well under 1% of the entries
        for name in jc:
            a, b = np.asarray(jc[name]), tc[name].numpy()
            if a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 4 and (d > 0).mean() < 1e-2, name
            else:
                r = np.abs(b - a) / np.maximum(np.abs(a), 1e-8)
                assert r.max() < 2e-2 and (r > 1e-4).mean() < 1e-2, name
    else:
        _assert_cache_close(jc, tc)
    for name in tc:
        np.testing.assert_allclose(_np(tc[name]), _np(tc_seq[name]), rtol=1e-5, atol=1e-5)
