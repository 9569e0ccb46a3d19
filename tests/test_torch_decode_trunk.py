"""The decode trunk's wrappers (``ops/decode_trunk.py``) on the CPU.

Each wrapper's CPU path gives the bits of the plain ops it replaces in
``model/llama.py`` (the residual add and ``rmsnorm``, ``apply_rope`` and
the indexed cache writes, ``F.silu`` times the up projection) at head dims
64 and 128 and GQA groups of 1, 3 and 4; each raises on what its kernel
does not take; and a whole decode step through them equals the plain
step (the twins) bit for bit, on a bf16 and on an int8 cache.  The kernels themselves are held to these twins on the
card (``tests/test_torch_cuda.py``)."""
import pytest
import torch
import torch.nn.functional as F

from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model import llama as tl
from project_morpheus_tpu_torch.model.quant import fuse_layer_weights, quantize_params_int8
from project_morpheus_tpu_torch.ops import decode_trunk as dt

BF = torch.bfloat16
SHAPES = [(64, 1), (64, 4), (128, 3), (128, 4), (128, 1)]  # (HD, G)


def _bf(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(BF)


@pytest.fixture(autouse=True)
def no_launches():
    dt.reset_launch_counts()
    yield
    assert dt.LAUNCHES == {"add_rmsnorm": 0, "rope_kv_write": 0, "swiglu": 0}


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("D", [64, 2048, 3072])
def test_add_rmsnorm_equals_the_add_and_rmsnorm(rows, D):
    g = torch.Generator().manual_seed(rows + D)
    x, d = _bf(g, rows, 1, D), _bf(g, rows, 1, D)
    w = (torch.rand(D, generator=g) + 0.5).to(BF)
    want_x = x + d
    got_x = x.clone()
    h = dt.add_rmsnorm(got_x, d, w, 1e-5)
    assert torch.equal(got_x, want_x)
    assert torch.equal(h, tl.rmsnorm(want_x, w, 1e-5))
    x0 = x.clone()
    assert torch.equal(dt.add_rmsnorm(x0, None, w, 1e-6), tl.rmsnorm(x, w, 1e-6))
    assert torch.equal(x0, x)  # no d: x is read, not written


@pytest.mark.parametrize("HD,G", SHAPES)
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_rope_kv_write_equals_rope_and_the_cache_writes(HD, G, rows):
    """q rotated and made contiguous, k rotated and v written at each
    slot's position (0 and S - 1 among them) of one layer; every other
    byte of both caches untouched."""
    KV, L, S = 2, 3, 64
    H = KV * G
    cfg = LlamaConfig(hidden_size=256, num_heads=H, num_kv_heads=KV, head_dim=HD,
                      rope_theta=500_000.0, rope_scaling_factor=32.0)
    inv = tl.rope_inv_freqs(cfg)
    g = torch.Generator().manual_seed(HD * G + rows)
    qkv = _bf(g, rows, 1, (H + 2 * KV) * HD, scale=3.0)
    lengths = torch.randint(0, S, (rows,), generator=g, dtype=torch.int32)
    lengths[0] = S - 1
    lengths[-1] = 0 if rows > 1 else lengths[-1]
    cache = {n: _bf(g, L, rows, KV, S, HD) for n in ("k", "v")}
    before = {n: t.clone() for n, t in cache.items()}
    q = dt.rope_kv_write(qkv, lengths, inv, cache["k"], cache["v"], 1)

    nq, nkv = H * HD, KV * HD  # the plain step's split of the fused output
    wq = qkv[..., :nq].reshape(rows, 1, H, HD)
    wk = qkv[..., nq:nq + nkv].reshape(rows, 1, KV, HD)
    wv = qkv[..., nq + nkv:].reshape(rows, 1, KV, HD)
    pos = lengths[:, None]
    want_q = tl.apply_rope(wq, pos, inv)[:, 0]
    want_k = tl.apply_rope(wk, pos, inv)[:, 0]
    assert q.shape == (rows, H, HD) and q.is_contiguous() and torch.equal(q, want_q)
    b, p = torch.arange(rows), lengths.long()
    assert torch.equal(cache["k"][1, b, :, p], want_k)
    assert torch.equal(cache["v"][1, b, :, p], wv[:, 0])
    for n in cache:
        restored = cache[n].clone()
        restored[1, b, :, p] = before[n][1, b, :, p]
        assert torch.equal(restored, before[n])


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("width", [128, 8192, 14336])
def test_swiglu_equals_silu_times_up(rows, width):
    g = torch.Generator().manual_seed(rows + width)
    gu = _bf(g, rows, 1, 2 * width, scale=4.0)
    act = dt.swiglu(gu, width)
    assert act.shape == (rows, 1, width)
    assert torch.equal(act, F.silu(gu[..., :width]) * gu[..., width:])


def _rope_args(rows=2, KV=2, HD=64, cache_dtype=BF):
    inv = torch.ones(HD // 2)
    lengths = torch.zeros(rows, dtype=torch.int32)
    cache = torch.zeros(2, rows, KV, 16, HD, dtype=cache_dtype)
    return [torch.zeros(rows, (2 + 2 * KV) * HD, dtype=BF), lengths, inv, cache, cache.clone(), 0]


@pytest.mark.parametrize("case", ["fp32", "rows", "width"])
def test_add_rmsnorm_raises_on_what_the_kernel_does_not_take(case):
    x = torch.zeros(17 if case == "rows" else 2, 8 if case != "width" else 12,
                    dtype=torch.float32 if case == "fp32" else BF)
    with pytest.raises(ValueError):
        dt.add_rmsnorm(x, None, torch.ones(x.shape[-1], dtype=BF), 1e-5)


@pytest.mark.parametrize("case", ["int8_cache", "fp32_qkv", "rows", "head_dim", "lengths"])
def test_rope_kv_write_raises_on_what_the_kernel_does_not_take(case):
    if case == "int8_cache":
        args = _rope_args(cache_dtype=torch.int8)
    elif case == "fp32_qkv":
        args = _rope_args()
        args[0] = args[0].float()
    elif case == "rows":
        args = _rope_args(rows=17)
    elif case == "head_dim":
        args = _rope_args(HD=24)
    else:
        args = _rope_args()
        args[1] = args[1].long()
    with pytest.raises(ValueError):
        dt.rope_kv_write(*args)


@pytest.mark.parametrize("case", ["fp32", "rows", "width"])
def test_swiglu_raises_on_what_the_kernel_does_not_take(case):
    gu = torch.zeros(17 if case == "rows" else 2, 24 if case == "width" else 32,
                     dtype=torch.float32 if case == "fp32" else BF)
    with pytest.raises(ValueError):
        dt.swiglu(gu, gu.shape[-1] // 2)


def _fill_cache(cache, g):
    """Random cache contents: bf16 normals, or int8 codes with positive
    scales."""
    for t in cache.values():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
        elif "scale" in cache and t is cache["scale"]:
            t.copy_(torch.rand(t.shape, generator=g) * 0.02 + 0.002)
        else:
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))


def _check_step_both_ways(monkeypatch, HD, G, attn_impl, cache_dtype, parts):
    """Three decode steps through the wrappers (``decode_trunk_parts`` as
    it comes out, which must be ``parts``) and through the plain chain (all
    parts forced off) give the same logits and cache, bit for bit."""
    KV = 2
    cfg = LlamaConfig(vocab_size=1024, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=KV * G, num_kv_heads=KV, head_dim=HD, max_seq_len=64)
    params = fuse_layer_weights(quantize_params_int8(tl.init_llama_params(cfg, 3, "cpu", BF)))
    B, S = 4, 64
    g = torch.Generator().manual_seed(HD + G)
    cache = tl.init_kv_cache(cfg, B, S, cache_dtype, "cpu")
    _fill_cache(cache, g)
    assert tl.decode_trunk_parts(params, cfg, cache, B) == parts
    runs = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(tl, "decode_trunk_parts", lambda *a: (False, False, False))
        c = {n: t.clone() for n, t in cache.items()}
        lengths = torch.tensor([0, 9, 30, S - 4], dtype=torch.int32)
        toks, logits = torch.tensor([5, 77, 300, 1000]), []
        for _ in range(3):
            logits.append(tl.llama_decode_step(params, toks, cfg, c, lengths,
                                               attn_impl=attn_impl, bucket=S))
            lengths = lengths + 1
            toks = logits[-1].argmax(-1)
        runs[fused] = (logits, c)
    for a, b in zip(runs[True][0], runs[False][0]):
        assert torch.equal(a, b)
    for n in cache:
        assert torch.equal(runs[True][1][n], runs[False][1][n])


@pytest.mark.parametrize("HD,G", SHAPES)
@pytest.mark.parametrize("attn_impl", ["dense", "kernel"])
def test_decode_step_through_the_wrappers_equals_the_plain_step(monkeypatch, HD, G, attn_impl):
    """Int8 fused weights and a bf16 cache, as served: three decode steps
    through the trunk's wrappers give the plain step's logits and cache,
    bit for bit."""
    _check_step_both_ways(monkeypatch, HD, G, attn_impl, BF, (True, True, True))


@pytest.mark.parametrize("HD,G", SHAPES)
@pytest.mark.parametrize("attn_impl", ["dense", "kernel"])
def test_decode_step_through_the_wrappers_equals_the_plain_step_on_an_int8_cache(
        monkeypatch, HD, G, attn_impl):
    """Int8 fused weights and an int8 cache, as Orpheus-3B serves: the
    add + norm and SwiGLU wrappers around the plain RoPE and quantized
    writes give the plain step's logits, codes and scales, bit for bit."""
    _check_step_both_ways(monkeypatch, HD, G, attn_impl, torch.int8, (True, False, True))


@pytest.mark.parametrize("case,want", [
    ("served", (True, True, True)),
    ("int8_cache", (True, False, True)),
    ("unfused", (True, False, False)),
    ("fp32", (False, False, False)),
    ("rows", (False, False, False)),
    ("head_dim", (True, False, True)),
])
def test_decode_trunk_parts(case, want):
    """Which parts take the wrappers: all of them as served (int8 fused
    weights, bf16 cache and activations, <= 16 slots); an int8 cache keeps
    the plain RoPE and writes, unfused weights (tensor parallelism) the
    plain projections, fp32 activations or 17 slots the plain chain, a
    head dim the kernel does not take the plain RoPE."""
    cfg = LlamaConfig(vocab_size=1024, hidden_size=64, intermediate_size=128, num_layers=1,
                      num_heads=4, num_kv_heads=2, head_dim=24 if case == "head_dim" else 16,
                      max_seq_len=32)
    params = tl.init_llama_params(cfg, 0, "cpu", torch.float32 if case == "fp32" else BF)
    params = quantize_params_int8(params)
    if case != "unfused":
        params = fuse_layer_weights(params)
    cache = tl.init_kv_cache(cfg, 4, 32, torch.int8 if case == "int8_cache" else BF, "cpu")
    assert tl.decode_trunk_parts(params, cfg, cache, 17 if case == "rows" else 4) == want
