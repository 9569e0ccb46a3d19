"""What limits the hand-written kernels: variants with one part skipped.

    python -m project_morpheus_tpu_torch.tools.kernel_ablation [VARIANT ...]
    python -m project_morpheus_tpu_torch.tools.kernel_ablation gemv [VARIANT ...]
    python -m project_morpheus_tpu_torch.tools.kernel_ablation prefill [VARIANT ...]

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

Prints one line per variant and round; needs a CUDA card.
"""
from __future__ import annotations

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
        ("                                          int c2, uint32_t bar) {\n",
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


def prefill_variant(src: str, name: str) -> str:
    """``prefill_chunk_attention.cu`` with variant ``name``'s edits (each
    anchor found exactly once, or for ``no_tma``'s expect_tx once per
    layout)."""
    for old, new in PREFILL_EDITS[name]:
        n = src.count(old)
        if n == 0 or (n > 1 and "expect_tx" not in old):
            raise ValueError(f"ablation anchor found {n} times in {PREFILL_SRC}: {old[:60]!r}")
        src = src.replace(old, new)
    return src


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
                cu = var_src / PREFILL_SRC
                cu.write_text(prefill_variant(cu.read_text(), name))
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

    from project_morpheus_tpu_torch.ops import build, decode_attention as da
    from project_morpheus_tpu_torch.tools import time_kernels as tk

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


if __name__ == "__main__":
    if sys.argv[1:2] == ["gemv"]:
        gemv_main(sys.argv[2:])
    elif sys.argv[1:2] == ["prefill"]:
        prefill_main(sys.argv[2:])
    else:
        main(sys.argv[1:] or list(VARIANTS))
