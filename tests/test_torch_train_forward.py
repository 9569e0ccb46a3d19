"""The port's full-sequence forward (``model/llama.py:llama_forward``)
against the JAX package's: dense and blockwise attention, a padding mask,
LoRA adapters, ``return_hidden``, and the cache-writing branches (the
head-major cache and the int8 position-major one, one row and several);
then the layouts that existed for XLA (grouped, unrolled, ``accum``)
against the canonical stacked one, in the port alone.

All fp32 on the CPU, weights drawn with ``jax.random`` and carried across
with ``model/bridge.py``.  Tolerances: forward 1e-5 of the largest
reference magnitude; grads 1e-4 of it; a bf16 cache one bf16 step (2**-7
relative); an int8 cache one quantisation step on at most 0.1% of values
(a value on a rounding half-step may land either side)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model import init_llama_params as jax_init
from project_morpheus_tpu.model import llama as jl
from project_morpheus_tpu.training.lora import LoraConfig as JaxLoraConfig
from project_morpheus_tpu.training.lora import init_lora_params as jax_init_lora
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model import llama as tl
from project_morpheus_tpu_torch.model.bridge import (
    group_layer_params,
    params_from_jax_numpy,
    ungroup_layer_params,
)
from project_morpheus_tpu_torch.training.pretrain import causal_lm_loss, tree_leaves, tree_unflatten

_jax_forward = jax.jit(jl.llama_forward, static_argnames=(
    "cfg", "attn_impl", "return_hidden", "remat", "scan_layers", "accum_stack_grads"))


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    cfg = JaxLlamaConfig.tiny_vocab()
    jp = jax_init(cfg, jax.random.key(3), dtype=jnp.float32)
    lc = JaxLoraConfig(rank=4)
    lora = jax_init_lora(cfg, lc, jax.random.key(1))
    # nonzero B so the adapters' delta is not trivially zero
    for i, name in enumerate(lora["layers"]):
        b = lora["layers"][name]["b"]
        lora["layers"][name]["b"] = jax.random.normal(jax.random.key(10 + i), b.shape) * 0.05
    return jp, lora


def _carry(tree):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree))


def _tokens(B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 1000, (B, S)).astype(np.int32)


@pytest.mark.parametrize("attn_impl,padded,with_lora,hidden", [
    ("dense", False, False, False), ("blockwise", False, False, False),
    ("dense", True, False, False), ("blockwise", True, False, False),
    ("dense", False, True, False), ("blockwise", True, True, True),
])
def test_forward_matches_jax(weights, attn_impl, padded, with_lora, hidden):
    """Logits (or final hidden states) on every row, padded rows included:
    one row is right-padded from 20, one has padding before its first key."""
    jp, jlora = weights
    cfg = LlamaConfig.tiny_vocab()
    ids = _tokens(3, 32, 0)
    mask = np.ones(ids.shape, bool)
    if padded:
        mask[1, 20:] = False
        mask[2, :5] = False
    kw = dict(lora_scale=2.0) if with_lora else {}
    want, _ = _jax_forward(jp, jnp.asarray(ids), cfg, attn_mask=jnp.asarray(mask),
                           lora=jlora if with_lora else None, attn_impl=attn_impl,
                           return_hidden=hidden, **kw)
    got, cache = tl.llama_forward(_carry(jp), torch.tensor(ids), cfg, attn_mask=torch.tensor(mask),
                                  lora=_carry(jlora) if with_lora else None, attn_impl=attn_impl,
                                  return_hidden=hidden, **kw)
    assert cache is None and got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("quant,B", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_cache_writes_match_jax(weights, quant, B):
    """Prefill through the full forward into a 3-lane cache: one row at
    lane 1 from position 3, or two rows at lanes (2, 0) from (0, 5), with
    RoPE positions from each row's offset."""
    jp, _ = weights
    cfg = LlamaConfig.tiny_vocab()
    S, Smax = 12, 24
    ids = _tokens(B, S, 1)
    lanes, offs = ([1], [3]) if B == 1 else ([2, 0], [0, 5])
    jcache = jl.init_kv_cache(cfg, 3, Smax, jnp.int8 if quant else jnp.bfloat16)
    tcache = tl.init_kv_cache(cfg, 3, Smax, torch.int8 if quant else torch.bfloat16)
    pos = (np.asarray(offs)[:, None] + np.arange(S)[None]).astype(np.int32)
    want, jcache = _jax_forward(jp, jnp.asarray(ids), cfg, positions=jnp.asarray(pos),
                                cache=jcache, cache_offset=jnp.asarray(offs, jnp.int32),
                                cache_slots=jnp.asarray(lanes, jnp.int32))
    got, tcache2 = tl.llama_forward(_carry(jp), torch.tensor(ids), cfg, positions=torch.tensor(pos),
                                    cache=tcache, cache_offset=torch.tensor(offs),
                                    cache_slots=torch.tensor(lanes))
    assert tcache2 is tcache  # written in place
    assert _rel(got, want) < 1e-5
    for name in jcache:
        a, b = np.asarray(jcache[name].astype(jnp.float32)), tcache[name].float().numpy()
        if name in ("k", "v") and quant:
            d = np.abs(a - b)
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(b, a, rtol=2**-7, atol=1e-6, err_msg=name)
        assert np.count_nonzero(b) == np.count_nonzero(a), name


def _loss_and_grads(params, batch, cfg, **kw):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = causal_lm_loss(params, batch, cfg, **kw)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_layouts_match_canonical(weights, attn_impl):
    """The grouped layout (one group, and one per layer), the unrolled loop
    and ``accum_stack_grads`` give the canonical stacked path's loss and
    grads; the grouped layout round-trips bit for bit."""
    jp, _ = weights
    cfg = LlamaConfig.tiny_vocab()
    ids = _tokens(2, 33, 2)
    batch = {"input_ids": ids, "attention_mask": np.ones(ids.shape, bool), "labels": ids}
    kw = dict(attn_impl=attn_impl, logits_chunk=8)
    l0, g0 = _loss_and_grads(_carry(jp), batch, cfg, remat=True, **kw)
    for groups in (1, cfg.num_layers):
        grouped = group_layer_params(_carry(jp), groups)
        l1, g1 = _loss_and_grads(grouped, batch, cfg, remat=True, **kw)
        g1 = tree_leaves(ungroup_layer_params(tree_unflatten(grouped, list(g1))))
        assert abs(float(l1 - l0)) <= 1e-6 * abs(float(l0))
        assert max(_rel(a, b) for a, b in zip(g1, g0)) < 1e-4
        rt = ungroup_layer_params(grouped)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(rt), tree_leaves(_carry(jp))))
    for extra in (dict(scan_layers=False, remat=True), dict(accum_stack_grads=True)):
        l2, g2 = _loss_and_grads(_carry(jp), batch, cfg, **kw, **extra)
        assert abs(float(l2 - l0)) <= 1e-6 * abs(float(l0)), extra
        assert max(_rel(a, b) for a, b in zip(g2, g0)) < 1e-4, extra
    with pytest.raises(ValueError):
        causal_lm_loss(group_layer_params(_carry(jp), 2), batch, cfg, accum_stack_grads=True)
