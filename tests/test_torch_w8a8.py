"""The port's w8a8 projections (``ops/w8a8_gemm.py``, ``model/quant.py``)
against the JAX package's ``matmul_w8a8``, on the CPU, where the wrappers
run their plain versions.

JAX's function runs op by op (not under ``jit``), so its divisions are
IEEE divisions, as the kernels' are; under ``jit`` XLA's CPU compiler
multiplies by the reciprocal of 127 instead, which moves ``hsc`` by an ulp
in a few rows in a hundred.  Every step is then exact or correctly rounded
in fp32 in both packages: the int8 codes, the scales and the outputs must
be equal, bit for bit (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import quant as jq
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model import llama as tl
from project_morpheus_tpu_torch.model import quant as tq
from project_morpheus_tpu_torch.ops import w8a8_gemm as wg

SIZES = [(M, K) for M in (1, 5, 64) for K in (64, 192)]


def _activations(M, K, seed):
    """Seeded rows; row 0 has peak 127 (hsc = 1) and values on .5 ties;
    the last row (of several) is zeros, which take the 1e-8 floor."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(M, K)).astype(np.float32) * 3
    h[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    if M > 1:
        h[-1] = 0
    return h


def _jax_quantization(h):
    """The int8 codes and fp32 scales JAX's ``matmul_w8a8`` computes for
    ``h`` (fp32): its dot is swapped for one that records the codes and
    returns ones, and a zero weight with unit scales leaves ``hsc`` as the
    output."""
    seen = {}
    real = jax.lax.dot_general

    def recording(a, b, *args, **kwargs):
        seen["h8"] = np.asarray(a)
        return jnp.ones(a.shape[:-1] + b.shape[-1:], jnp.int32)

    w = {"q": jnp.zeros((h.shape[-1], 1), jnp.int8), "scale": jnp.ones((1,), jnp.float32)}
    jax.lax.dot_general = recording
    try:
        hsc = np.asarray(jq.matmul_w8a8(jnp.asarray(h), w))
    finally:
        jax.lax.dot_general = real
    return seen["h8"], hsc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K", SIZES)
def test_quantize_rows_plain_equals_jax(M, K, dtype):
    """Codes and scales equal JAX's, ties at .5 and the zero row included
    (bf16 rows are rounded before both packages see them)."""
    h = torch.from_numpy(_activations(M, K, seed=M * K)).to(dtype)
    h8, hsc = wg.quantize_rows_plain(h)
    jh8, jhsc = _jax_quantization(h.float().numpy())
    assert h8.dtype == torch.int8 and hsc.dtype == torch.float32 and hsc.shape == (M, 1)
    np.testing.assert_array_equal(h8.numpy(), jh8)
    np.testing.assert_array_equal(hsc.numpy(), jhsc)
    if M == 1 or K == 64:  # the ties round half to even (hsc = 1)
        np.testing.assert_array_equal(h8[0, 1:6].numpy(), [0, 2, 2, 0, -2])
    if M > 1:
        assert hsc[-1].item() == np.float32(np.float32(1e-8) / np.float32(127))


@pytest.mark.parametrize("N", [128, 384])
@pytest.mark.parametrize("M,K", SIZES)
def test_matmul_w8a8_equals_jax(M, K, N):
    """The port's ``matmul_w8a8`` (the plain quantize and GEMM) equals
    JAX's output bit for bit, in fp32 and in bf16."""
    rng = np.random.default_rng(M + K + N)
    h = _activations(M, K, seed=N)
    w = jq.quantize_weight(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    tw = {n: torch.from_numpy(np.array(t)) for n, t in w.items()}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq.matmul_w8a8(jnp.asarray(h).astype(jdt), w).astype(jnp.float32))
        got = tq.matmul_w8a8(torch.from_numpy(h).to(tdt), tw)
        assert got.dtype == tdt and got.shape == (M, N)
        np.testing.assert_array_equal(got.float().numpy(), want)
        h8, hsc = wg.quantize_rows(torch.from_numpy(h).to(tdt))
        direct = wg.w8a8_gemm(h8, hsc, tw["q"].T.contiguous(), tw["scale"], tdt)
        assert torch.equal(direct, got)


@pytest.mark.parametrize("M", [5, 64])
@pytest.mark.parametrize("K,N", [(2048, 64), (2048, 200), (1040, 64), (1040, 200)])
def test_matmul_w8a8_tails_equal_jax(M, K, N):
    """The plain quantize and GEMM (the kernels' references on the card)
    equal JAX's ``matmul_w8a8`` bit for bit where N and K are not multiples
    of 128: Orpheus-1B's ``wk`` at tp = 8, (2048, 64), an N tail (200) and a
    K tail (1040, a multiple of 16 only)."""
    rng = np.random.default_rng(M * N + K)
    h = _activations(M, K, seed=K + N)
    w = jq.quantize_weight(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    tw = {n: torch.from_numpy(np.array(t)) for n, t in w.items()}
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    want = np.asarray(jq.matmul_w8a8(hb, w).astype(jnp.float32))
    th = torch.from_numpy(h).to(torch.bfloat16)
    h8, hsc = wg.quantize_rows_plain(th)
    jh8, jhsc = _jax_quantization(th.float().numpy())
    np.testing.assert_array_equal(h8.numpy(), jh8)
    np.testing.assert_array_equal(hsc.numpy(), jhsc)
    got = wg.w8a8_gemm_plain(h8, hsc, tw["q"].T.contiguous(), tw["scale"], torch.bfloat16)
    assert got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("M,K,N,want", [
    (32, 3072, 5120, (64, 96, 1)), (32, 3072, 3072, (64, 96, 1)), (32, 3072, 16384, (64, 128, 1)),
    (64, 8192, 3072, (64, 96, 4)), (128, 3072, 3072, (128, 96, 4)), (65, 3072, 16384, (128, 128, 1)),
    (1, 2048, 64, (64, 128, 8)), (64, 1040, 200, (64, 96, 1)), (100, 1536, 3072, (128, 96, 1)),
    (129, 3072, 3072, (128, 128, 1)), (1024, 3072, 5120, (128, 128, 1)),
    (1024, 8192, 3072, (128, 256, 1))])
def test_gemm_plan_on_short_rounds(M, K, N, want):
    """Up to 128 rows: 64-row tiles up to 64 rows, and the tile width and
    split of K with the least estimated time on 132 SMs (one wave; a split
    where a block's share of the weight would stream longer than the card
    needs for all of it, plus the split's reduction), two weight tiles
    requested early; from 129 rows the 128-row tiles of ``block_n``,
    unsplit, none early."""
    plan = wg.gemm_plan(M, N, K, 132)
    assert plan[:3] == want
    bm, bn, cs, prefetch = plan
    assert prefetch == (wg.SHORT_PREFETCH if M <= 128 else 0)
    if M <= 128:
        blocks = -(-N // bn) * cs
        assert (bn // 8) % cs == 0 and cs <= -(-K // 128) and (cs == 1 or blocks <= 132)
        for other_bn in wg.SHORT_TILE_N:  # no valid plan is estimated faster
            for other_cs in wg.SPLITS:
                if other_cs == 1 or ((other_bn // 8) % other_cs == 0 and other_cs <= -(-K // 128)
                                     and -(-N // other_bn) * other_cs <= 132):
                    assert wg.short_call_s(M, N, K, bm, bn, cs, 132) <= \
                        wg.short_call_s(M, N, K, bm, other_bn, other_cs, 132)


def test_gemm_plan_keeps_every_cluster_resident():
    """Where the card holds fewer clusters of a split than its column tiles
    (a cluster's blocks share a GPC), the plan takes a split it holds."""
    assert wg.gemm_plan(32, 3072, 8192, 132)[:3] == (64, 96, 4)
    held = lambda bm, bn, cs: 28 if cs == 4 else 66  # noqa: E731
    assert wg.gemm_plan(32, 3072, 8192, 132, held)[:3] == (64, 128, 4)  # 24 clusters


@pytest.mark.parametrize("magnitude", [1e-6, 1.0, 3.0, 1e4])
def test_reciprocal_codes_equal_division(magnitude):
    """The quantize kernel's codes (``csrc/w8a8_gemm.cu: code_of``, here in
    fp32 PyTorch ops): ``rint(x * (1 / hsc))``, or ``rint(x / hsc)`` where
    the product lies within 2**-14 of a half-integer, equal ``rint(x /
    hsc)`` for every value: the product is within 2**-16 of the rounded
    quotient.  Rows of normals, ties on .5 and the values that make them."""
    gen = torch.Generator().manual_seed(int(magnitude * 7) + 1)
    x = torch.randn(512, 2048, generator=gen) * magnitude
    x[:, :64] = torch.arange(64, dtype=torch.float32) * 0.5 - 16
    peak = x.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(peak, min=1e-8) / torch.tensor(127.0)
    r = torch.tensor(1.0) / s
    q = x * r
    c = torch.round(q)
    near = (q - c).abs() >= 0.5 - 2.0**-14
    exact = torch.round(x / s)
    assert torch.equal(torch.where(near, exact, c), exact)
    assert near.float().mean() < 1e-2


@pytest.mark.parametrize("site", ["quantize_kv", "dense q", "dense p", "weight", "embedding"])
def test_int8_scale_sites_equal_jax(site):
    """The five scales that divide by 127 (``quant.div127``: a tensor
    divisor, so the card divides too) equal JAX's op by op, bit for bit:
    ``quantize_kv``, the dense int8 branch's query and probability scales
    (JAX ``llama.py:1148-1150``, ``:1171``, inline there, so their
    expressions are run here), the weights' and the embedding's."""
    from project_morpheus_tpu.model import llama as jl

    rng = np.random.default_rng(len(site))
    x = (rng.normal(size=(6, 4, 64)) * 3).astype(np.float32)
    x[0, 0] = 0  # the floor
    if site == "quantize_kv":
        got, want = tl.quantize_kv(torch.from_numpy(x))[1], jl.quantize_kv(jnp.asarray(x))[1]
    elif site == "dense q":
        got = tl.int8_q_scale(torch.from_numpy(x))
        want = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=-1), 1e-8) / 127.0
    elif site == "dense p":
        p = np.abs(x) * 1e-3
        got = tl.int8_p_scale(torch.from_numpy(p))
        want = jnp.maximum(jnp.max(jnp.asarray(p), axis=-1), 1e-30) / 127.0
    elif site == "weight":
        w = x.reshape(24, 64)
        got, want = tq.quantize_weight(torch.from_numpy(w))["scale"], \
            jq.quantize_weight(jnp.asarray(w))["scale"]
    else:
        e = x.reshape(24, 64)
        got = tq.quantize_params_int8({"embed": torch.from_numpy(e), "layers": {}})["embed"]
        want = jq.quantize_params_int8({"embed": jnp.asarray(e), "layers": {}})["embed"]
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        got, want = got["scale"], want["scale"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K", SIZES)
def test_amax_hook_over_row_halves_equals_whole_row(M, K):
    """A row split in two (a tensor-parallel row-split input): each half
    quantized with the other half's maxima folded in by the hook gives the
    whole row's codes and scales; the halves' int8 products summed in fp32
    match the whole row's output within its rounding (each half's output
    and the whole's round to bf16 once: 2**-8 of each)."""
    rng = np.random.default_rng(K)
    h = torch.from_numpy(_activations(M, K, seed=K + 1)).to(torch.bfloat16)
    w = tq.quantize_weight(torch.from_numpy(rng.normal(size=(K, 128)).astype(np.float32)))
    halves = (h[:, :K // 2], h[:, K // 2:])
    peaks = [x.float().abs().amax(dim=-1, keepdim=True) for x in halves]
    hook = lambda peak: torch.maximum(peaks[0], peaks[1])  # noqa: E731
    whole8, whole_sc = wg.quantize_rows_plain(h)
    parts = [wg.quantize_rows(x, amax=hook) for x in halves]
    assert torch.equal(torch.cat([p[0] for p in parts], -1), whole8)
    for _, sc in parts:
        assert torch.equal(sc, whole_sc)
    y = tq.matmul_w8a8(h, w)
    ys = [tq.matmul_w8a8(x, {"q": q, "scale": w["scale"]}, amax=hook)
          for x, q in zip(halves, (w["q"][:K // 2], w["q"][K // 2:]))]
    total = ys[0].float() + ys[1].float()
    bound = 2.0**-8 * (ys[0].float().abs() + ys[1].float().abs() + y.float().abs()) + 1e-6
    assert torch.all((total - y.float()).abs() <= bound)


def _int8_params(cfg):
    return tq.fuse_layer_weights(tq.quantize_params_int8(
        tl.init_llama_params(cfg, 5, "cpu", torch.float32)))


def _with_copies(params):
    """``add_k_major_copies`` as the card makes them, made on the CPU."""
    layers = {k: ({**w, "qt": w["q"].transpose(-1, -2).contiguous()} if tq.is_quantized(w)
                  else w) for k, w in params["layers"].items()}
    return {**params, "layers": layers}


def test_layer_slice_carries_k_major_copy():
    cfg = LlamaConfig.tiny_vocab()
    lp = _with_copies(_int8_params(cfg))["layers"]
    wl = tl._layer(lp, 1)
    for key in ("wqkv", "wo", "wgu", "wd"):
        assert set(wl[key]) == {"q", "scale", "qt"}
        assert torch.equal(wl[key]["qt"], lp[key]["q"][1].T)
        assert wl[key]["qt"].untyped_storage().data_ptr() == \
            lp[key]["qt"].untyped_storage().data_ptr()  # a view, not a copy


def test_prefill_same_with_and_without_k_major_copies():
    """``llama_prefill_chunk_batch`` with ``w8a8`` gives the same logits and
    cache bits whether the leaves carry their K-major copies or not."""
    cfg = LlamaConfig.tiny_vocab()
    params = _int8_params(cfg)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, 16))).int()
    out = []
    for p in (params, _with_copies(params)):
        cache = tl.init_kv_cache(cfg, 3, 64, torch.int8, "cpu")
        logits = tl.llama_prefill_chunk_batch(p, tokens, cfg, cache, [0, 16], [2, 0], [16, 11],
                                              hist_bucket=32, w8a8=True)
        out.append((logits, cache))
    assert torch.equal(out[0][0], out[1][0])
    for name in out[0][1]:
        assert torch.equal(out[0][1][name], out[1][1][name])


def test_cpu_engine_and_params_make_no_k_major_copy():
    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine

    cfg = LlamaConfig.tiny_vocab()
    params = _int8_params(cfg)
    assert tq.add_k_major_copies(params)["layers"] == params["layers"]
    eng = OrpheusEngine(params, cfg, EngineConfig(max_slots=2, max_seq_len=128,
                                                  cache_dtype="int8"), device="cpu")
    assert eng._w8a8
    for w in eng.params["layers"].values():
        assert not (tq.is_quantized(w) and "qt" in w)


@pytest.mark.parametrize("M,N,want", [(1024, 3072, 256), (1024, 5120, 128), (1024, 16384, 256),
                                      (128, 3072, 128), (4096, 3072, 256), (1000, 1536, 128),
                                      (33, 1280, 128)])
def test_tile_width_follows_the_grid(M, N, want):
    """256-wide tiles unless 128-wide ones take fewer waves of the same
    work on 132 SMs; N not a multiple of 256 takes 128."""
    assert wg.block_n(M, N, 132) == want


def test_wrappers_reject_tensors_off_cpu_and_cuda():
    h = torch.empty(4, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or all on one cuda"):
        wg.quantize_rows(h)
    h8 = torch.zeros(4, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="cpu or all on one cuda"):
        wg.w8a8_gemm(h8, torch.ones(4, 1), torch.zeros(128, 128, dtype=torch.int8,
                                                        device="meta"),
                     torch.ones(128), torch.bfloat16)
