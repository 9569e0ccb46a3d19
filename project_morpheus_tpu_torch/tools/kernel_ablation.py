"""What limits the hand-written kernels: variants with one part skipped.

    python -m project_morpheus_tpu_torch.tools.kernel_ablation [VARIANT ...]
    python -m project_morpheus_tpu_torch.tools.kernel_ablation gemv [VARIANT ...]
    python -m project_morpheus_tpu_torch.tools.kernel_ablation prefill [VARIANT ...]
    python -m project_morpheus_tpu_torch.tools.kernel_ablation w8a8 [VARIANT ...]

Decode attention:

Each variant is ``ops/csrc`` with one edit to ``flash_decode.cuh``, built
into ``ops/_build/ablation/<variant>`` and timed with
``time_kernels.graph_ms`` at the mixed and all-live 3B shapes, twice, in
turns.  A skipped part stays in the binary behind a condition that is false
at run time (``sm_scale > 1e30``), so the rest compiles as it does in the
kernel.  Variants that skip work compute wrong outputs: they are timings,
never checked.

- ``kernel``: the sources as they are;
- ``no_arith``: every tile's scores, softmax and P.V skipped, so copies,
  block exits and the merge remain;
- ``no_scales``: the int8 scale copies skipped;
- ``no_arith_no_scales``: both;
- ``stages2``: a 2-stage ring (a 4-stage one does not fit the bf16
  kernel's 64 KB stages in shared memory);
- ``warps4``: 4 warps a block, 64-position tiles.

The int8 GEMV (``gemv``): ``int8_gemv.cu`` with one edit, built the same
way and timed at the five Orpheus-3B weight shapes at M = 8 rows
(``time_kernels.gemv_shapes``), 28 stacked layers cycled so L2 is cold:
``graph_ms`` over back-to-back calls, and ``chained_ms`` with a small
dependent add between calls, as in serving.  The edits follow the design
of the source they find (the ticket design of earlier commits, or the
cluster design), so a parent commit's kernel is ablated by copying this
file and ``time_kernels.py`` into a ``git archive`` of that commit and
running it there:

- ``kernel``: the source as it is;
- ``loads_only``: every weight and activation load kept (their words
  folded into one value that is never stored), the int8 -> bf16
  conversion, the products and everything after the K loop skipped;
- ``no_reduce``: the split-K reduction skipped: each block stops after its
  own partial sum (the ticket design: stores it; the cluster design: stops
  before the cluster exchange);
- ``empty``: every block returns at once, on the same grid and launch.

The chunk-prefill attention (``prefill``): ``prefill_chunk_attention.cu``
with one part skipped, built the same way and timed with
``time_kernels.graph_ms`` (28 layers cycled) at ``PREFILL_ABLATION_SHAPES``:
the head shape (J = 4, C = 1024 at 7168, hist 8192) and the main path's
first round (J = 1, C = 1024 at 0, hist 1024), int8 and bf16 caches, twice
in turns:

- ``kernel``: the source as it is;
- ``no_convert``: the int8 tiles' conversion to bf16 skipped (the scale
  columns still copied, the rings still handed over);
- ``no_softmax``: every tile's mask, maxima and exponentials skipped after
  a block's first tile (the scores go to P.V as they are);
- ``no_pv``: the P.V products skipped;
- ``no_tma``: no tile copied: the producer arrives on each stage without a
  copy, so the consumers read whatever the ring holds (a fixed tile);
- ``loads_only``: the consumers only wait for each tile and hand it back
  (the copies, and for int8 the conversion, with nothing to feed);
- ``keys128``: 128-key tiles for a bf16 cache (3 stages) instead of 64
  (an int8 cache's tiles are 64 keys either way: its two rings must fit).

The w8a8 GEMM (``w8a8``): ``w8a8_gemm.cu`` with one part skipped, or the
source as it is under another plan (``ops/w8a8_gemm.py``'s ``PLAN``), timed
at the four Orpheus-3B weights (``time_kernels.W8A8_PAIRS``) at
``W8A8_ABLATION_ROWS`` rows with ``time_kernels.graph_ms`` (28 layers
cycled): the GEMM alone, and the quantize + GEMM pair as a projection runs
it, and the quantize alone; twice in turns:

- ``kernel``: the source and the plan as they are;
- ``plan_128``: the plan of more than 128 rows at every row count (128 x
  128 or 128 x 256 tiles, no split, no early weight tiles);
- ``tile128``: the plan with 128-row tiles;
- ``no_prefetch``, ``prefetch_all``: no weight tiles, or the whole ring,
  requested before the kernel ahead ends (the plan: two on short calls);
- ``no_dependent``: the GEMM launched as an ordinary kernel;
- ``bn96_split1`` ... ``bn128_split4``: short calls with the tile width
  and the split of K set (the plan's where its tile or the card's cluster
  occupancy does not allow them);
- ``loads_only``: the tiles copied and handed back, no product, no
  epilogue;
- ``no_reduce``: a split's blocks stop after their own partial sums;
- ``empty``: every block returns at once, on the same grid and launch.

Prints one line per variant and round; needs a CUDA card.
"""
from __future__ import annotations

import importlib
import shutil
import sys

FALSE = "if (a.sm_scale > 1e30f) {\n"
ARITH = ("    // scores: (16 positions)", "\n  }\n  cp_async_wait<0>();")
SCALE_COPY = "      cp_async4(smem_addr(ss + tid), src, ok);"


def _skip(src: str, begin: str, end: str) -> str:
    i = src.index(begin)
    j = src.index(end, i)
    return src[:i] + FALSE + src[i:j] + "\n}" + src[j:]


def _no_scales(src: str) -> str:
    if SCALE_COPY not in src:
        raise ValueError("scale copy not found in flash_decode.cuh")
    return src.replace(SCALE_COPY, "      if (a.sm_scale > 1e30f) " + SCALE_COPY.lstrip())


def _const(name: str, old: int, new: int):
    def edit(src: str) -> str:
        line = f"constexpr int {name} = {old};"
        if line not in src:
            raise ValueError(f"{line} not found in flash_decode.cuh")
        return src.replace(line, f"constexpr int {name} = {new};")
    return edit


VARIANTS = {
    "kernel": lambda s: s,
    "no_arith": lambda s: _skip(s, *ARITH),
    "no_scales": _no_scales,
    "no_arith_no_scales": lambda s: _no_scales(_skip(s, *ARITH)),
    "stages2": _const("kStages", 3, 2),
    "warps4": _const("kWarps", 8, 4),
}


# ------------------------------------------------------------ int8 GEMV

# Never true at run time (M <= 16): a part skipped behind it stays in the
# binary, so the rest compiles as it does in the kernel.
NEVER = "M > 1000"


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"ablation anchor found {src.count(old)} times in int8_gemv.cu, "
                         f"not once: {old[:60]!r}")
    return src.replace(old, new)


# the ticket design: per-lane register loads, partials in global memory and
# the last block of a column tile (an atomic ticket) reducing them
TICKET = {
    "empty": [
        ("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n",
         "  if (M > 0) return;\n  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"),
        ("  const int warps = gridDim.x * kWarps;\n",
         "  if (M > 0) return;\n  const int warps = gridDim.x * kWarps;\n"),
    ],
    "loads_only": [
        ("  float acc[kN8][8][4];\n", "  float acc[kN8][8][4];\n  uint32_t sink = 0;\n"),
        ("#pragma unroll\n    for (int u = 0; u < kU; ++u) {\n      const uint4 r0 = flip(",
         "#pragma unroll\n    for (int u = 0; u < kU; ++u)\n#pragma unroll\n"
         "      for (int j = 0; j < 4; ++j)\n"
         "        sink ^= w[u][j].x ^ w[u][j].y ^ w[u][j].z ^ w[u][j].w ^ b[u][0][j & 1];\n"
         "#pragma unroll\n    for (int u = 0; u < kU; ++u) {\n"
         f"      if (!({NEVER})) continue;\n      const uint4 r0 = flip("),
        ("  // tile t: mma row g",
         f"  if (!({NEVER})) {{\n    if (sink == 0x9e3779b9u) static_cast<float*>(out)[0] = 1.f;\n"
         "    return;\n  }\n  // tile t: mma row g"),
        ("    float acc[4] = {0.f, 0.f, 0.f, 0.f};\n",
         "    float acc[4] = {0.f, 0.f, 0.f, 0.f};\n    uint32_t sink = 0;\n"),
        ("#pragma unroll\n      for (int u = 0; u < kU; ++u) {\n        const uint4 f = flip(w[u]);",
         "#pragma unroll\n      for (int u = 0; u < kU; ++u)\n"
         "        sink ^= w[u].x ^ w[u].y ^ w[u].z ^ w[u].w ^ x0[u][0].x ^ x0[u][1].y ^ x1[u][0].z"
         " ^ x1[u][1].w;\n"
         "#pragma unroll\n      for (int u = 0; u < kU; ++u) {\n"
         f"        if (!({NEVER})) continue;\n        const uint4 f = flip(w[u]);"),
        ("    const int c = tile * 8 + tid4 * 2;\n",
         f"    if (!({NEVER})) {{\n      if (sink == 0x9e3779b9u) static_cast<float*>(out)[0] = 1.f;\n"
         "      continue;\n    }\n    const int c = tile * 8 + tid4 * 2;\n"),
    ],
    "no_reduce": [
        ("  if (n_ksplit == 1) return;\n  __threadfence();",
         "  return;\n  __threadfence();"),
    ],
}

# the cluster design: a TMA ring fed by a producer warp, split-K summed in
# a thread-block cluster over distributed shared memory
_HAND_BACK = ("    if (!({never})) {{\n      __syncwarp();\n"
              "      if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));\n      continue;\n    }}\n")
CLUSTER = {
    "empty": [
        ("  using G = KN<kRows>;\n  constexpr",
         "  if (M > 0) return;\n  using G = KN<kRows>;\n  constexpr"),
        ("  using G = NK<kRows>;\n  extern",
         "  if (M > 0) return;\n  using G = NK<kRows>;\n  extern"),
    ],
    "loads_only": [
        ("      mbar_wait(smem_u32(&full[slot]), (j / kStages) & 1);\n",
         "      mbar_wait(smem_u32(&full[slot]), (j / kStages) & 1);\n"
         + "  " + _HAND_BACK.format(never=NEVER).replace("\n    ", "\n      ")),
        ("    float* red = reinterpret_cast<float*>(smem);\n",
         f"    float* red = reinterpret_cast<float*>(smem);\n    if ({NEVER}) {{\n"),
        ("      st_cluster(smem_u32(inbox + rank * per + o - owner * per), owner, s);\n    }\n",
         "      st_cluster(smem_u32(inbox + rank * per + o - owner * per), owner, s);\n    }\n"
         "    }\n"),
        ("  cluster_sync();\n  if (warp < kCons) {\n",
         f"  cluster_sync();\n  if (warp < kCons && {NEVER}) {{\n"),
        ("      mbar_wait(smem_u32(&full[slot]), (g / kStagesNK) & 1);\n",
         "      mbar_wait(smem_u32(&full[slot]), (g / kStagesNK) & 1);\n"
         + "  " + _HAND_BACK.format(never=NEVER).replace("\n    ", "\n      ")),
        ("    float sum[4];\n", f"    if (!({NEVER})) continue;\n    float sum[4];\n"),
    ],
    "no_reduce": [
        ("      st_cluster(", f"      if ({NEVER}) st_cluster("),
        ("  cluster_sync();\n  if (warp < kCons) {\n",
         f"  if ({NEVER}) cluster_sync();\n  if (warp < kCons && {NEVER}) {{\n"),
    ],
}

GEMV_DESIGNS = {"g_tickets[": TICKET, "barrier.cluster": CLUSTER}


def gemv_variant(src: str, name: str) -> str:
    """``int8_gemv.cu`` with variant ``name``'s edits for its design."""
    if name == "kernel":
        return src
    design = next((d for marker, d in GEMV_DESIGNS.items() if marker in src), None)
    if design is None:
        raise ValueError("int8_gemv.cu matches no known design")
    for old, new in design[name]:
        src = _edit(src, old, new)
    return src


GEMV_VARIANTS = ("kernel", "loads_only", "no_reduce", "empty")


def gemv_main(argv) -> None:
    import subprocess

    import torch

    from project_morpheus_tpu_torch.ops import build, int8_gemv as ig
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA card")
    names = argv or list(GEMV_VARIANTS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    M = 8
    ops = {}
    for shape, (K, N, k_major, layers) in tk.gemv_shapes().items():
        wshape = (layers, N, K) if k_major else (layers, K, N)
        q = torch.randint(-127, 128, wshape, generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(layers, N, generator=g, device=dev) * 0.02 + 1e-3
        h0 = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        ops[shape] = (q, sc, h0, h0.clone(), k_major, layers)
    own_csrc, own_build, own_sources = build.CSRC, build.BUILD_DIR, build.SOURCES
    try:
        for rnd in range(2):
            for name in names:
                var_src = own_build / "ablation" / f"gemv_{name}" / "csrc"
                if var_src.exists():
                    shutil.rmtree(var_src)
                shutil.copytree(own_csrc, var_src)
                cu = var_src / ig.SOURCE
                cu.write_text(gemv_variant(cu.read_text(), name))
                build.CSRC, build.BUILD_DIR, build.SOURCES = var_src, var_src.parent, (ig.SOURCE,)
                build._libs.clear()
                build.build_all()
                row = []
                for shape, (q, sc, h0, h, k_major, layers) in ops.items():
                    fn = lambda i: ig.int8_gemv(h, q[i % layers], sc[i % layers],  # noqa: E731
                                                k_major=k_major)
                    back = tk.graph_ms(fn)
                    chain, link = tk.chained_ms(fn, tk.gemv_link(torch, h, h0))
                    row.append(f"{shape} {back * 1e3:.2f} / {chain * 1e3:.2f} us (add {link * 1e3:.2f})")
                print(f"round {rnd} gemv {name} [back-to-back / chained]: " + "; ".join(row),
                      flush=True)
    finally:
        build.CSRC, build.BUILD_DIR, build.SOURCES = own_csrc, own_build, own_sources
        build._libs.clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


# ------------------------------------------------------------ chunk-prefill attention

PREFILL_SRC = "prefill_chunk_attention.cu"
PREFILL_ABLATION_SHAPES = ((4, 1024, 8192, 7168), (1, 1024, 1024, 0))  # (J, C, hist, offset)
PREFILL_EDITS = {
    "kernel": [],
    "no_convert": [
        ("        for (int k = 0; k < 2 * kBK * kPieces / kConvThreads; ++k) {\n",
         "        if (a.sm_scale > 1e30f)\n"
         "        for (int k = 0; k < 2 * kBK * kPieces / kConvThreads; ++k) {\n"),
    ],
    "no_softmax": [
        ("      softmax(t, al_lo, al_hi);\n",
         "      if (a.sm_scale > 1e30f) softmax(t, al_lo, al_hi); else al_lo = al_hi = 1.f;\n"),
    ],
    "no_pv": [
        ("      wgmma_pv<HD>(o, pf[kk], d, 1);\n",
         "      if (a.sm_scale > 1e30f) wgmma_pv<HD>(o, pf[kk], d, 1);\n"),
    ],
    "no_tma": [
        ("hopper.cuh", "                                          int c2, uint32_t bar) {\n",
         "                                          int c2, uint32_t bar) {\n  return;\n"),
        ("        mbar_expect_tx(bar, bytes);\n", "        mbar_expect_tx(bar, 0u);\n"),
    ],
    "loads_only": [
        ("  for (int t = 0; t < min(nt_w, kFirstBlock / kBK); ++t) {\n",
         "  for (int t = 0; t < (a.sm_scale > 1e30f ? min(nt_w, kFirstBlock / kBK) : 0); ++t) {\n"),
        ("  if (nt_w > 0) {\n    float al_lo, al_hi;\n",
         "  if (nt_w > 0 && a.sm_scale > 1e30f) {\n    float al_lo, al_hi;\n"),
        ("  for (int t = nt_w; t < n_tiles; ++t) {  // tiles past this warpgroup's rows\n",
         "  for (int t = a.sm_scale > 1e30f ? nt_w : 0; t < n_tiles; ++t) {\n"),
    ],
    "keys128": [
        ("constexpr int kKeysBf = 64;", "constexpr int kKeysBf = 128;"),
        ("constexpr int kStages = 6;", "constexpr int kStages = 3;"),
    ],
}


def prefill_variant(csrc, name: str) -> None:
    """Apply variant ``name``'s edits to the copy of ``ops/csrc`` at
    ``csrc``: an edit ``(old, new)`` to ``prefill_chunk_attention.cu``, an
    edit ``(file, old, new)`` to that file (each anchor found exactly once,
    or for ``no_tma``'s expect_tx once per layout)."""
    for edit in PREFILL_EDITS[name]:
        file, old, new = edit if len(edit) == 3 else (PREFILL_SRC, *edit)
        path = csrc / file
        src = path.read_text()
        n = src.count(old)
        if n == 0 or (n > 1 and "expect_tx" not in old):
            raise ValueError(f"ablation anchor found {n} times in {file}: {old[:60]!r}")
        path.write_text(src.replace(old, new))


def prefill_main(argv) -> None:
    import subprocess

    import torch

    from project_morpheus_tpu_torch.ops import build, prefill_attention as pa
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA card")
    names = argv or list(PREFILL_EDITS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    caches = {quant: tk.prefill_cache(torch, quant, dev, g) for quant in (True, False)}
    calls = []
    for quant, cache in caches.items():
        for J, C, hist, off in PREFILL_ABLATION_SHAPES:
            st = torch.tensor(tk.PREFILL_SLOTS[J], dtype=torch.int32, device=dev)
            ot = torch.full((J,), off, dtype=torch.int32, device=dev)
            q = torch.randn(J, C, tk.H, tk.HD, generator=g, device=dev).to(torch.bfloat16)
            label = f"{'int8' if quant else 'bf16'} J={J} C={C} off={off} hist={hist}"
            calls.append((label, cache, q, st, ot, hist))
    own_csrc, own_build, own_sources = build.CSRC, build.BUILD_DIR, build.SOURCES
    try:
        for rnd in range(2):
            for name in names:
                var_src = own_build / "ablation" / f"prefill_{name}" / "csrc"
                if var_src.exists():
                    shutil.rmtree(var_src)
                shutil.copytree(own_csrc, var_src)
                prefill_variant(var_src, name)
                build.CSRC, build.BUILD_DIR, build.SOURCES = var_src, var_src.parent, (PREFILL_SRC,)
                build._libs.clear()
                build.build_all()
                row = []
                for label, cache, q, st, ot, hist in calls:
                    ms = tk.graph_ms(lambda i: pa.prefill_chunk_attention(
                        q, {n: t[i % tk.L] for n, t in cache.items()}, st, ot, hist))
                    row.append(f"{label} {ms:.4f} ms")
                print(f"round {rnd} prefill {name}: " + "; ".join(row), flush=True)
    finally:
        build.CSRC, build.BUILD_DIR, build.SOURCES = own_csrc, own_build, own_sources
        build._libs.clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


# ------------------------------------------------------------ decode attention


def main(names) -> None:
    import torch

    from project_morpheus_tpu_torch.ops import build
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    da = importlib.import_module("project_morpheus_tpu_torch.ops.decode_attention")

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(tk.B, tk.H, tk.HD, generator=g, device=dev).to(torch.bfloat16)
    k8 = torch.randint(-127, 128, (tk.L, tk.B, tk.S, tk.KV * tk.HD), generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (tk.L, tk.B, tk.S, tk.KV * tk.HD), generator=g, device=dev,
                       dtype=torch.int8)
    sc = torch.rand(tk.L, tk.B, tk.S, 2 * tk.KV, generator=g, device=dev) * 0.02 + 0.002
    kb = torch.randn(tk.L, tk.B, tk.KV, tk.S, tk.HD, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(tk.L, tk.B, tk.KV, tk.S, tk.HD, generator=g, device=dev).to(torch.bfloat16)
    lens = {n: torch.tensor(v, dtype=torch.int32, device=dev) for n, v in tk.SHAPES.items()}
    csrc, build_dir = build.CSRC, build.BUILD_DIR
    try:
        for rnd in range(2):
            for name in names:
                var_src = build_dir / "ablation" / name / "csrc"
                if var_src.exists():
                    shutil.rmtree(var_src)
                shutil.copytree(csrc, var_src)
                hdr = var_src / "flash_decode.cuh"
                hdr.write_text(VARIANTS[name](hdr.read_text()))
                build.CSRC, build.BUILD_DIR = var_src, var_src.parent
                build._libs.clear()
                build.build_all()
                row = []
                for shape, lt in lens.items():
                    ms = tk.graph_ms(lambda i: da.decode_attention_int8_slots(q, k8, v8, sc, lt,
                                                                              i % tk.L))
                    ml = tk.graph_ms(lambda i: da.decode_attention_layered(q, kb, vb, lt, i % tk.L))
                    row.append(f"slot {shape} {ms:.4f} ms, layered {shape} {ml:.4f} ms")
                print(f"round {rnd} {name}: " + "; ".join(row), flush=True)
    finally:
        build.CSRC, build.BUILD_DIR = csrc, build_dir
        build._libs.clear()


# ------------------------------------------------------------ w8a8 GEMM

W8A8_SRC = "w8a8_gemm.cu"
W8A8_ABLATION_ROWS = (32, 128, 1024)
_NEVER, _ALWAYS = "M > (1 << 30)", "M < (1 << 30)"
_SPLIT_SYNCS = "if (splits > 1) {\n      cluster_sync();\n      cluster_sync();\n    }\n"
_WGMMA = ("    wgmma_fence();\n#pragma unroll\n    for (int ks = 0; ks < kBK / 32; ++ks) {\n"
          "      wgmma_s8<BN>(acc, sw128_desc(a + 32 * ks, 16, 1024), sw128_desc(b + 32 * ks, 16, "
          "1024),\n                   j > 0 || ks > 0);\n    }\n    wgmma_commit();\n"
          "    wgmma_wait<1>();  // tile j - 1's products are done: its stage goes back\n")
W8A8_EDITS = {
    "empty": [("  const int mine = (rank + 1) * k_tiles / splits - kt0;  // this block's K tiles\n",
               "  const int mine = (rank + 1) * k_tiles / splits - kt0;  // this block's K tiles\n"
               f"  if ({_ALWAYS}) return;\n")],
    "loads_only": [(_WGMMA, f"    if ({_NEVER}) {{\n{_WGMMA}    }}\n"),
                   ("  wgmma_wait<0>();\n  keep(acc);\n",
                    f"  if ({_ALWAYS}) {{\n    {_SPLIT_SYNCS}    return;\n  }}\n"
                    "  wgmma_wait<0>();\n  keep(acc);\n")],
    "no_reduce": [("  const int per = BN / 8 / splits;\n  cluster_sync();\n",
                   f"  if ({_ALWAYS}) {{\n    cluster_sync();\n    cluster_sync();\n    return;\n"
                   "  }\n  const int per = BN / 8 / splits;\n  cluster_sync();\n")],
}


def _plan_variants(wg):
    """name -> planner (M, N, K, device) -> plan, from the wrapper's own."""
    card = wg.card_plan

    def sms(dev):
        return wg._sm_count(dev)

    def split(cs, bn):
        def plan(M, N, K, dev):
            bm, plan_bn, plan_cs, pre = card(M, N, K, dev)
            if M > wg.SHORT_ROWS or (bn // 8) % cs or cs > -(-K // wg.TILE_K) or (
                    cs > 1 and -(-N // bn) > wg.max_clusters(dev, bm, bn, cs)):
                return bm, plan_bn, plan_cs, pre
            return bm, bn, cs, pre
        return plan

    return {
        "kernel": card,
        "plan_128": lambda M, N, K, dev: (128, wg.block_n(M, N, sms(dev)), 1, 0),
        "tile128": lambda M, N, K, dev: (128, *card(M, N, K, dev)[1:]),
        "no_prefetch": lambda M, N, K, dev: (*card(M, N, K, dev)[:3], 0),
        "prefetch_all": lambda M, N, K, dev: (*card(M, N, K, dev)[:3], wg.PREFETCH_ALL),
        "no_dependent": card,
        **{f"bn{bn}_split{cs}": split(cs, bn) for bn in wg.SHORT_TILE_N for cs in (1, 2, 4)},
    }


def w8a8_main(argv) -> None:
    import subprocess

    import torch

    from project_morpheus_tpu_torch.ops import build, w8a8_gemm as wg
    from project_morpheus_tpu_torch.tools import time_kernels as tk

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA card")
    plans = _plan_variants(wg)
    names = argv or [*plans, *W8A8_EDITS]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    weights = {}
    for name in ("wqkv", "wo", "wgu", "wd"):
        K, N = tk.W8A8_PAIRS[name]
        qt = torch.randint(-127, 128, (tk.L, N, K), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(tk.L, N, generator=g, device=dev) * 0.02 + 1e-3
        hs = {M: torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
              for M in W8A8_ABLATION_ROWS}
        weights[name] = (K, N, qt, scale, hs)
    own_csrc, own_build, own_sources = build.CSRC, build.BUILD_DIR, build.SOURCES
    own_plan, own_dep = wg.PLAN, wg.DEPENDENT_LAUNCH
    try:
        for rnd in range(2):
            for name in names:
                var_src = own_build / "ablation" / f"w8a8_{name}" / "csrc"
                if var_src.exists():
                    shutil.rmtree(var_src)
                shutil.copytree(own_csrc, var_src)
                cu = var_src / W8A8_SRC
                src = cu.read_text()
                for old, new in W8A8_EDITS.get(name, []):
                    if src.count(old) != 1:
                        raise ValueError(f"ablation anchor found {src.count(old)} times in "
                                         f"{W8A8_SRC}: {old[:60]!r}")
                    src = src.replace(old, new)
                cu.write_text(src)
                build.CSRC, build.BUILD_DIR, build.SOURCES = var_src, var_src.parent, (W8A8_SRC,)
                build._libs.clear()
                wg._CLUSTERS.clear()
                build.build_all()
                wg.PLAN = plans.get(name, own_plan)
                wg.DEPENDENT_LAUNCH = name != "no_dependent"
                row = []
                for M in W8A8_ABLATION_ROWS:
                    gemm_sum = pair_sum = quant_sum = 0.0
                    for wname, (K, N, qt, scale, hs) in weights.items():
                        h = hs[M]
                        h8, hsc = wg.quantize_rows(h)
                        gemm = tk.graph_ms(lambda i: wg.w8a8_gemm(h8, hsc, qt[i % tk.L],
                                                                  scale[i % tk.L], torch.bfloat16))
                        pair = tk.w8a8_pair_ms(torch, wg, h, qt, scale, wg.DEPENDENT_LAUNCH)
                        quant = tk.graph_ms(lambda i: wg.quantize_rows(h))
                        gemm_sum += gemm
                        pair_sum += pair
                        quant_sum += quant
                        row.append(f"{wname} M={M} {wg.PLAN(M, N, K, dev)} {gemm * 1e3:.2f} / "
                                   f"{pair * 1e3:.2f} / {quant * 1e3:.2f} us")
                    row.append(f"SUM M={M} {gemm_sum * 1e3:.2f} / {pair_sum * 1e3:.2f} / "
                               f"{quant_sum * 1e3:.2f} us")
                print(f"round {rnd} w8a8 {name} [gemm / quantize + gemm / quantize]: "
                      + "; ".join(row), flush=True)
    finally:
        build.CSRC, build.BUILD_DIR, build.SOURCES = own_csrc, own_build, own_sources
        build._libs.clear()
        wg._CLUSTERS.clear()
        wg.PLAN, wg.DEPENDENT_LAUNCH = own_plan, own_dep
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["gemv"]:
        gemv_main(sys.argv[2:])
    elif sys.argv[1:2] == ["prefill"]:
        prefill_main(sys.argv[2:])
    elif sys.argv[1:2] == ["w8a8"]:
        w8a8_main(sys.argv[2:])
    else:
        main(sys.argv[1:] or list(VARIANTS))
