"""Checks that need the card: each CUDA kernel against its plain twin (the
chunk-prefill attention too), the
engine's frame programs replayed from CUDA graphs against the same
programs run eagerly, an HF checkpoint directory loaded onto the card
against the same params passed directly, train steps on the card against
the CPU, the training attention's SDPA path against its twin, and the
w8a8 quantize and GEMM against their plain versions, bit for bit.  This file imports no JAX, so it runs where the port
runs (``python -m pytest tests/test_torch_cuda.py`` on a machine with a
card); everywhere else each test skips.

Tolerances: a bf16 kernel output against an fp32 twin,
|err| <= 1e-2 |ref| + 2e-3 (bf16 rounding of the output plus summation
order); the int8 GEMV against its bf16 twin, 2**-6 |ref| + 1e-3 (the twin
rounds three times to bf16: the product, the scale and the scaled output;
the kernel once: up to about two bf16 ulps apart); the w8a8 kernels none
(every step is exact or correctly rounded)."""
import pytest
import torch

import chip_smoke
from project_morpheus_tpu_torch.model import hf_weights as hw
from project_morpheus_tpu_torch.model.llama import init_llama_params
from project_morpheus_tpu_torch.ops import decode_attention as da
from project_morpheus_tpu_torch.ops import int8_gemv as ig
from project_morpheus_tpu_torch.ops import prefill_attention as pa
from project_morpheus_tpu_torch.ops import w8a8_gemm as wg
from project_morpheus_tpu_torch.tools import graph_check as gc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("HD,G", [(128, 3), (64, 4)])
def test_cuda_kernels_match_twins(cuda, HD, G):
    """Both decode-attention kernels (the layered one with bf16 and int8
    caches) at the Orpheus-3B (128, 3) and 1B (64, 4) head shapes, with one
    slot past the capacity and one of length 0 (zeros)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L, B, S, KV = 2, 6, 1024, 8
    H = KV * G
    lens = torch.tensor([0, 1, 65, 700, 1024, 1024 + 100], dtype=torch.int32, device=cuda)
    q = torch.randn(B, H, HD, generator=g, device=cuda).to(torch.bfloat16)
    k8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=cuda, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, B, S, KV * HD), generator=g, device=cuda, dtype=torch.int8)
    sc = torch.rand(L, B, S, 2 * KV, generator=g, device=cuda) * 0.02
    kb = torch.randn(L, B, KV, S, HD, generator=g, device=cuda).to(torch.bfloat16)
    vb = torch.randn(L, B, KV, S, HD, generator=g, device=cuda).to(torch.bfloat16)
    k8h = k8.view(L, B, S, KV, HD).transpose(2, 3).contiguous()
    v8h = v8.view(L, B, S, KV, HD).transpose(2, 3).contiguous()
    ksh = sc[..., :KV].transpose(2, 3).contiguous()
    vsh = sc[..., KV:].transpose(2, 3).contiguous()
    cases = [
        (da.decode_attention_int8_slots(q, k8, v8, sc, lens, 1),
         da.decode_attention_int8_slots_plain(q.float(), k8, v8, sc, lens, 1)),
        (da.decode_attention_layered(q, kb, vb, lens, 1),
         da.decode_attention_layered_plain(q.float(), kb, vb, lens, 1)),
        (da.decode_attention_layered(q, k8h, v8h, lens, 1, k_scale=ksh, v_scale=vsh),
         da.decode_attention_layered_plain(q.float(), k8h, v8h, lens, 1, ksh, vsh)),
    ]
    torch.cuda.synchronize()
    for got, want in cases:
        err = (got.float() - want).abs()
        assert torch.all(err <= 1e-2 * want.abs() + 2e-3)
        assert torch.all(got[0] == 0)


def _prefill_layer(g, cuda, quant, B, S, KV, HD):
    """One layer of a random cache in either layout of ``model/llama.py``."""
    if quant:
        return {"k": torch.randint(-127, 128, (B, S, KV * HD), generator=g, device=cuda,
                                   dtype=torch.int8),
                "v": torch.randint(-127, 128, (B, S, KV * HD), generator=g, device=cuda,
                                   dtype=torch.int8),
                "scale": torch.rand(B, S, 2 * KV, generator=g, device=cuda) * 0.02 + 0.002}
    return {n: torch.randn(B, KV, S, HD, generator=g, device=cuda).to(torch.bfloat16)
            for n in ("k", "v")}


def _prefill_garbage(layer, slot, frontier):
    """Large finite values past a job's frontier: read only by a kernel that
    attends past a query's position."""
    if "scale" in layer:
        layer["k"][slot, frontier:], layer["v"][slot, frontier:] = 127, -127
        layer["scale"][slot, frontier:] = 1e3
    else:
        layer["k"][slot, :, frontier:], layer["v"][slot, :, frontier:] = 1e4, -1e4


def _assert_prefill_close(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs()
    assert torch.all(err <= 1e-2 * want.abs() + 2e-3), err.max()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("HD,G", [(128, 3), (64, 4)])
@pytest.mark.parametrize("quant", [True, False])
def test_prefill_chunk_attention_matches_twin(cuda, HD, G, quant):
    """The chunk-prefill kernel against its twin (same bf16 rounding points)
    with int8 and bf16 histories, garbage past each frontier, at the
    design's edges: one job; three on non-adjacent slots at their own
    offsets (one at 0, one mid-tile, one whose chunk ends at the bucket);
    chunks whose rows end mid-warpgroup (C * G not a multiple of 64; at
    G = 4 a block's second consumer warpgroup gets no rows); four jobs of
    very different work (one at 0, one ending at the bucket) on
    non-adjacent slots; a chunk whose first key tile straddles its
    frontier; and a CUDA graph captured at one set of offsets and slots,
    replayed at another, equal to an eager call at the second."""
    g = torch.Generator(device=cuda).manual_seed(HD + G)
    B, S, KV, hist = 6, 1024, 8, 512
    H = KV * G
    cases = (  # (slots, offsets, chunk)
        ([4], [300], 80),
        ([5, 1, 3], [0, 197, hist - 80], 80),
        ([2], [64], 37),
        ([0, 4], [5, hist - 21], 21),
        ([0, 2, 5, 3], [0, hist - 96, 131, 260], 96),
        ([1], [100], 40),
    )
    for slots, offsets, C in cases:
        J = len(slots)
        layer = _prefill_layer(g, cuda, quant, B, S, KV, HD)
        for b, off in zip(slots, offsets):
            _prefill_garbage(layer, b, off + C)
        q = torch.randn(J, C, H, HD, generator=g, device=cuda).to(torch.bfloat16)
        st = torch.tensor(slots, dtype=torch.int32, device=cuda)
        ot = torch.tensor(offsets, dtype=torch.int32, device=cuda)
        pa.reset_launch_counts()
        got = pa.prefill_chunk_attention(q, layer, st, ot, hist)
        want = pa.prefill_chunk_attention_plain(q, layer, st, ot, hist).float()
        torch.cuda.synchronize()
        assert pa.LAUNCHES["prefill_chunk_attention"] == 1
        _assert_prefill_close(got, want.view(J, C, H * HD))

    # captured at (slots, offsets) A, replayed at B: equal to eager at B
    C, slots_a, offs_a, slots_b, offs_b = 64, [1, 4], [0, 128], [5, 2], [hist - 64, 77]
    layer = _prefill_layer(g, cuda, quant, B, S, KV, HD)
    for b, off in zip(slots_b, offs_b):
        _prefill_garbage(layer, b, off + C)
    q = torch.randn(2, C, H, HD, generator=g, device=cuda).to(torch.bfloat16)
    st = torch.tensor(slots_a, dtype=torch.int32, device=cuda)
    ot = torch.tensor(offs_a, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the first (eager) call sizes the kernel's shared memory
        pa.prefill_chunk_attention(q, layer, st, ot, hist)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = pa.prefill_chunk_attention(q, layer, st, ot, hist)
    st.copy_(torch.tensor(slots_b, dtype=torch.int32))
    ot.copy_(torch.tensor(offs_b, dtype=torch.int32))
    graph.replay()
    eager = pa.prefill_chunk_attention(q, layer, st, ot, hist)
    want = pa.prefill_chunk_attention_plain(q, layer, st, ot, hist).float()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    _assert_prefill_close(eager, want.view(2, C, H * HD))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 8, 13, 16])
@pytest.mark.parametrize("k_major,K,N", [(False, 256, 1280), (False, 8192, 3072),
                                         (False, 3072, 3072), (False, 336, 1040),
                                         (False, 2048, 1024), (False, 256, 16384),
                                         (True, 3072, 1000), (True, 256, 4096),
                                         (True, 400, 1000)])
def test_int8_gemv_matches_twin(cuda, M, k_major, K, N):
    """The GEMV in both layouts against its twin: (K, N) with clusters of
    1 (256 x 16384), 2, 4 (8192 x 3072, and the wo shape 3072 x 3072) and
    8 blocks (2048 x 1024) on a 132-SM card, a ragged last column tile and
    a K that is not a whole number of 128-row stages (336 x 1040); (N, K)
    with a ragged last row tile (N = 1000) and a K that is not a whole
    number of 64-wide h boxes (400)."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    h = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    shape = (N, K) if k_major else (K, N)
    q = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.02 + 1e-3
    ig.reset_launch_counts()
    got = ig.int8_gemv(h, q, scale, k_major=k_major)
    want = ig.int8_gemv_plain(h, q, scale, k_major)
    torch.cuda.synchronize()
    assert ig.LAUNCHES["int8_gemv"] == 1
    assert got.dtype == (torch.float32 if k_major else torch.bfloat16) and got.shape == (M, N)
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= 2**-6 * want.float().abs() + 1e-3), err.max()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k_major,K,N", [(False, 3072, 3072), (False, 3072, 16384),
                                         (True, 3072, 4000)])
def test_int8_gemv_same_bits_eager_and_replayed(cuda, k_major, K, N):
    """The same call gives the same bits eagerly, again, and replayed from
    a captured CUDA graph: the K split is summed in a fixed order."""
    g = torch.Generator(device=cuda).manual_seed(K + N)
    h = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    shape = (N, K) if k_major else (K, N)
    q = torch.randint(-127, 128, shape, generator=g, device=cuda, dtype=torch.int8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.02 + 1e-3
    first = ig.int8_gemv(h, q, scale, k_major=k_major)
    again = ig.int8_gemv(h, q, scale, k_major=k_major)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ig.int8_gemv(h, q, scale, k_major=k_major)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ig.int8_gemv(h, q, scale, k_major=k_major)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for r in replays:
        assert torch.equal(first, r)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_graph_replay_matches_eager(cuda, temperature):
    """The same seeded requests give the same tokens whether the frame
    programs are replayed from CUDA graphs or run eagerly."""
    (graph_toks, graph_programs), (eager_toks, eager_programs) = gc.graph_and_eager_traces(
        cuda, temperature)
    assert graph_programs.replays > 0 and eager_programs.captures == 0
    assert all(len(t) == gc.MAX_TOKENS for t in graph_toks)
    assert graph_toks == eager_toks


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 8])
def test_untied_lm_head_gemv_matches_twin(cuda, M):
    """An untied checkpoint's lm_head goes through the GEMV's (K, N) layout
    at the 3B width: 3072 x 157,184."""
    K, N = 3072, 157184
    g = torch.Generator(device=cuda).manual_seed(M)
    h = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randint(-127, 128, (K, N), generator=g, device=cuda, dtype=torch.int8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.02 + 1e-3
    got = ig.int8_gemv(h, q, scale)
    want = ig.int8_gemv_plain(h, q, scale, False).float()
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    err = (got.float() - want).abs()
    assert torch.all(err <= 2**-6 * want.abs() + 1e-3), err.max()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tie", [True, False])
def test_hf_checkpoint_on_card_matches_direct_params(cuda, tie, tmp_path):
    """A small bf16 HF directory (written by ``chip_smoke.py``'s writer),
    tied and untied, loads onto the card bit for bit and serves the same
    greedy traces as the params passed directly."""
    cfg = gc.small_config(vocab_size=1000, tie_embeddings=tie)
    params = init_llama_params(cfg, 5, cuda, torch.bfloat16)
    params["embed"][cfg.vocab_size:] = 0
    if not tie:
        params["lm_head"][:, cfg.vocab_size:] = 0
    chip_smoke.write_hf_checkpoint(tmp_path, params, cfg)
    loaded, lcfg = hw.load_hf_checkpoint(tmp_path, device=cuda)
    assert lcfg.tie_embeddings is tie and ("lm_head" in loaded) is not tie
    for key in ("embed", "ln_f", "lm_head"):
        if key in params:
            assert torch.equal(loaded[key].view(torch.int16), params[key].view(torch.int16))
    for key, v in params["layers"].items():
        assert torch.equal(loaded["layers"][key].view(torch.int16), v.view(torch.int16))
    got, _ = gc.serve_traces(gc.small_engine(cuda, True, loaded, lcfg), 0.0)
    want, _ = gc.serve_traces(gc.small_engine(cuda, True, params, cfg), 0.0)
    assert got == want and all(len(t) == gc.MAX_TOKENS for t in got)


@pytest.fixture
def fp32_exact(cuda):
    """TF32 off for matmuls and cuDNN while the test runs (fp32 card vs CPU)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.requires_cuda
@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_train_steps_card_match_cpu(fp32_exact, attn_impl):
    """Two ``make_train_step`` steps of a small fp32 model (warmup 1, so
    one at a nonzero rate) on the card and on the CPU, TF32 off: losses to
    1e-5 relative, the updates to 1e-3 in relative L2 norm (AdamW amplifies
    differences in near-zero gradient elements; see
    ``test_torch_training.py``)."""
    import numpy as np

    from project_morpheus_tpu_torch.training import pretrain as tp

    cfg = gc.small_config()
    start = init_llama_params(cfg, 3, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.vocab_size, (2, 256)).astype(np.int32)
    mask = np.ones(ids.shape, bool)
    mask[1, 180:] = False
    batch = {"input_ids": ids, "attention_mask": mask, "labels": np.where(mask, ids, -100)}
    tc = tp.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for dev in ("cpu", fp32_exact):
        params = tp.tree_map(lambda t: t.to(dev, copy=True), start)
        opt = tp.make_optimizer(tc)
        state, step = opt.init(params), tp.make_train_step(cfg, opt, attn_impl=attn_impl)
        runs[str(dev)] = (params, [float(step(params, state, batch)[2]) for _ in range(2)])
    (pc, lc), (pg, lg) = runs["cpu"], runs[str(fp32_exact)]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lg, lc))
    num = den = 0.0
    for g, c, s in zip(tp.tree_leaves(pg), tp.tree_leaves(pc), tp.tree_leaves(start)):
        want = c.detach().double() - s.double()
        num += float(((g.detach().cpu().double() - s.double() - want) ** 2).sum())
        den += float((want ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


@pytest.mark.requires_cuda
def test_training_attention_card_matches_twin(cuda):
    """The card's training attention (SDPA under ``SDPA_BACKEND``) against
    the plain blockwise twin on the card, bf16 at the 3B head shape, right
    padding and a row whose sequence starts with padding: forward within
    1e-2 |ref| + 2e-3, dq/dk/dv within 2e-2 of the largest magnitude."""
    from project_morpheus_tpu_torch.ops import blockwise_attention as ba

    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, H, KV, HD = 2, 1024, 24, 8, 128
    q, k, v, w = (torch.randn(B, S, h, HD, generator=g, device=cuda).to(torch.bfloat16)
                  for h in (H, KV, KV, H))
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda)
    mask[0, 900:] = False
    mask[1, :300] = False

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, mask)
        return out.detach(), torch.autograd.grad((out.float() * w.float()).sum(), leaves)

    out, grads = run(ba.blockwise_causal_attention)
    want, wgrads = run(ba.blockwise_attention_twin)
    err = (out.float() - want.float()).abs()
    assert torch.all(err <= 1e-2 * want.float().abs() + 2e-3), err.max()
    for a, b in zip(grads, wgrads):
        assert (a.float() - b.float()).abs().max() <= 2e-2 * b.float().abs().max()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("KV,G,HD", [(1, 3, 128), (1, 4, 64), (2, 3, 128), (4, 3, 128),
                                     (8, 3, 128)])
@pytest.mark.parametrize("quant", [True, False])
def test_prefill_chunk_attention_any_kv_heads(cuda, KV, G, HD, quant):
    """The chunk-prefill kernel at a tensor-parallel rank's kv heads: one
    (Orpheus-3B and 1B at tp = 8), two, four and eight; the int8 scale rows
    of a lane, a tile's run of 2KV floats a position, copied whole.  One
    job, and two whose chunks end at the bucket, garbage past each
    frontier; a cache of 5 slots x 1,023 positions, so at KV = 1 the scale
    array's second layer (the one used) starts 8 bytes past a 16-byte
    boundary."""
    g = torch.Generator(device=cuda).manual_seed(KV * 10 + G)
    B, S, hist = 5, 1023, 512
    for slots, offsets, C in (([3], [100], 96), ([4, 0], [hist - 64, hist - 40], 40)):
        full = {n: torch.stack([t, t]) for n, t in
                _prefill_layer(g, cuda, quant, B, S, KV, HD).items()}
        layer = {n: t[1] for n, t in full.items()}
        for b, off in zip(slots, offsets):
            _prefill_garbage(layer, b, off + C)
        q = torch.randn(len(slots), C, KV * G, HD, generator=g, device=cuda).to(torch.bfloat16)
        st = torch.tensor(slots, dtype=torch.int32, device=cuda)
        ot = torch.tensor(offsets, dtype=torch.int32, device=cuda)
        got = pa.prefill_chunk_attention(q, layer, st, ot, hist)
        want = pa.prefill_chunk_attention_plain(q, layer, st, ot, hist).float()
        torch.cuda.synchronize()
        _assert_prefill_close(got, want.view(len(slots), C, KV * G * HD))


# the Orpheus-3B w8a8 weights (K, N) and two tp = 2 halves
W8A8_SHAPES = [(3072, 5120), (3072, 3072), (3072, 16384), (8192, 3072), (1536, 3072),
               (4096, 3072)]


def _w8a8_inputs(g, cuda, M, K, N):
    h = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    # row 0: peak 127, so hsc = 1 and the codes of .5, 1.5, 2.5, -.5 are ties
    h[0].clamp_(-100, 100)
    h[0, :5] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5])
    qt = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.02 + 1e-3
    return h, qt, scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 33, 1000])
@pytest.mark.parametrize("K,N", W8A8_SHAPES)
def test_w8a8_kernels_equal_plain(cuda, M, K, N):
    """The quantize and the GEMM equal their plain versions bit for bit at
    row tails, at each 3B weight and two tp = 2 halves (128-wide tiles at
    1 and 33 rows, 256-wide at 1000 but for N = 5120); a zero row takes
    the 1e-8 floor."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    h, qt, scale = _w8a8_inputs(g, cuda, M, K, N)
    if M > 1:
        h[-1] = 0
    wg.reset_launch_counts()
    h8, hsc = wg.quantize_rows(h)
    want8, wantsc = wg.quantize_rows_plain(h)
    assert wg.LAUNCHES["w8a8_quantize"] == 1
    assert torch.equal(h8, want8) and torch.equal(hsc, wantsc)
    want = wg.w8a8_gemm_plain(h8, hsc, qt, scale, torch.bfloat16)
    got = wg.w8a8_gemm(h8, hsc, qt, scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    got32 = wg.w8a8_gemm(h8, hsc, qt, scale, torch.float32)
    assert torch.equal(got32, wg.w8a8_gemm_plain(h8, hsc, qt, scale, torch.float32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [1, 32, 64, 65, 128])
@pytest.mark.parametrize("K,N", [(2048, 64), (2048, 200), (1040, 128), (1040, 200), (1040, 1),
                                 (3072, 5120), (3072, 3072), (8192, 3072), (384, 3072)])
def test_w8a8_short_plans_and_tails_equal_plain(cuda, M, K, N):
    """The short rounds' plans (64-row tiles up to 64 rows, K split over a
    cluster, 96- and 128-wide tiles) and the N and K tails (N not a
    multiple of 128, odd N, K a multiple of 16 only) equal the plain
    versions bit for bit, bf16 and fp32 out, with and without the
    dependent launch."""
    g = torch.Generator(device=cuda).manual_seed(M * 7 + K + N)
    h, qt, scale = _w8a8_inputs(g, cuda, M, K, N)
    h8, hsc = wg.quantize_rows(h)
    want8, wantsc = wg.quantize_rows_plain(h)
    assert torch.equal(h8, want8) and torch.equal(hsc, wantsc)
    bm, bn, splits, _ = wg.PLAN(M, N, K, cuda)
    assert bm == (64 if M <= 64 else 128)
    keep = wg.DEPENDENT_LAUNCH
    try:
        for dependent in (True, False):
            wg.DEPENDENT_LAUNCH = dependent
            for dt in (torch.bfloat16, torch.float32):
                got = wg.w8a8_gemm(h8, hsc, qt, scale, dt)
                want = wg.w8a8_gemm_plain(h8, hsc, qt, scale, dt)
                torch.cuda.synchronize()
                assert got.shape == (M, N)
                assert torch.equal(got, want), (bm, bn, splits, dependent, dt)
    finally:
        wg.DEPENDENT_LAUNCH = keep


@pytest.mark.requires_cuda
def test_w8a8_short_plans_fit_the_card(cuda):
    """At the 3B weights' short rounds (and a tp = 8 rank's) the card's
    plan is one wave with every cluster resident at once, and K is split at
    the longest weight (wd, K = 8192)."""
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name in ("wqkv", "wo", "wgu", "wd", "wq/8", "1b wk/8"):
        K, N = tk.W8A8_PAIRS[name]
        for M in (32, 128):
            bm, bn, splits, _ = wg.PLAN(M, N, K, cuda)
            tiles = -(-N // bn)
            assert splits == 1 or (tiles * splits <= sms
                                   and tiles <= wg.max_clusters(cuda, bm, bn, splits))
            if name == "wd":
                assert splits > 1


@pytest.mark.requires_cuda
def test_w8a8_quantize_amax_hook(cuda):
    """With a hook the quantize launches twice (the rows' maxima, then the
    rows from the hook's maxima) and equals the plain version given it; an
    fp32 input too."""
    g = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn(2, 17, 256, generator=g, device=cuda).to(torch.bfloat16)
    hook = lambda peak: peak * 1.5  # noqa: E731
    for x in (h, h.float()):
        wg.reset_launch_counts()
        h8, hsc = wg.quantize_rows(x, amax=hook)
        assert wg.LAUNCHES["w8a8_quantize"] == 2
        want8, wantsc = wg.quantize_rows_plain(x, amax=hook)
        assert h8.shape == x.shape and hsc.shape == (2, 17, 1)
        assert torch.equal(h8, want8) and torch.equal(hsc, wantsc)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M,K,N", [(1000, 3072, 16384), (33, 8192, 3072), (32, 3072, 5120),
                                   (100, 2048, 64)])
def test_w8a8_same_bits_eager_and_replayed(cuda, M, K, N):
    """The quantize and the GEMM replayed from a captured CUDA graph give
    the eager call's bits."""
    g = torch.Generator(device=cuda).manual_seed(M)
    h, qt, scale = _w8a8_inputs(g, cuda, M, K, N)

    def run():
        h8, hsc = wg.quantize_rows(h)
        return wg.w8a8_gemm(h8, hsc, qt, scale, torch.bfloat16)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.requires_cuda
def test_w8a8_leaf_without_k_major_copy_raises(cuda):
    """On the card matmul_w8a8 needs the K-major copy; add_k_major_copies
    adds it and the product then equals the CPU's bits."""
    from project_morpheus_tpu_torch.model.quant import (
        add_k_major_copies, matmul_w8a8, quantize_weight)

    g = torch.Generator().manual_seed(2)
    w = quantize_weight(torch.randn(2, 256, 384, generator=g))
    h = torch.randn(5, 256, generator=g).to(torch.bfloat16)
    leaf = {n: t.to(cuda) for n, t in w.items()}
    with pytest.raises(ValueError, match="K-major"):
        matmul_w8a8(h.to(cuda), {n: t[1] for n, t in leaf.items()})
    lp = add_k_major_copies({"layers": {"wo": leaf}})["layers"]["wo"]
    assert torch.equal(lp["qt"], leaf["q"].transpose(1, 2))
    got = matmul_w8a8(h.to(cuda), {n: t[1] for n, t in lp.items()})
    want = matmul_w8a8(h, {n: t[1] for n, t in w.items()})
    assert torch.equal(got.cpu(), want)
