"""What limits the decode-attention kernels: variants with one part skipped.

    python -m project_morpheus_tpu_torch.tools.kernel_ablation [VARIANT ...]

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
    main(sys.argv[1:] or list(VARIANTS))
