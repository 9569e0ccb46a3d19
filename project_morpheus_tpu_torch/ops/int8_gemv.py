"""Int8 weight-only GEMV for the decode step (CUDA, ``csrc/int8_gemv.cu``).

``y = (h @ q) * scale`` for bf16 activations ``h`` of at most
``MAX_ROWS`` rows and an int8 weight used where it lies:

- ``k_major=False``: ``q`` is ``(K, N)`` (one layer of a stacked
  projection), output bf16;
- ``k_major=True``: ``q`` is ``(N, K)`` (the tied embedding as lm_head,
  ``y = h @ q.T``), output fp32 logits.

Not a port of a Pallas kernel: it does what XLA does for the JAX package's
``matmul_maybe_quant`` and ``tied_lm_head_logits`` (``model/quant.py``),
folding the int8 -> bf16 cast into the product, so each weight byte is read
once and no bf16 copy of the weight is written.  Bound: device-memory
bytes (3.30 GB a 3B decode step, 0.99 ms at 3.35 TB/s; the table is in
the source).

On a CPU tensor the wrapper runs the plain twin, the math of
``model/quant.py``; on a CUDA tensor it launches the kernel or raises.  The
kernel accumulates in fp32 and rounds once, where the twin rounds to bf16
three times (the product, the scale, the scaled output): they differ by up
to about two bf16 ulps of the output (2**-6 relative bounds it).
``LAUNCHES`` counts wrapper calls that launched it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "int8_gemv.cu"
MAX_ROWS = 16
# (K, N) layout: columns per block, warps per block, and the blocks the
# K split aims for (one on each of the H100's 132 SMs; two fit, but more
# splits only add partials to reduce)
_COLS, _WARPS, _TARGET_BLOCKS = 128, 8, 132

LAUNCHES = {"int8_gemv": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def int8_gemv_plain(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    k_major: bool = False) -> torch.Tensor:
    """Plain twin: the dequant-then-matmul of ``model/quant.py``."""
    from ..model.quant import dequant_matmul, dequant_matmul_t

    return dequant_matmul_t(h, q, scale) if k_major else dequant_matmul(h, q, scale)


def k_splits(K: int, N: int) -> int:
    """Blocks along K for the (K, N) layout: as many as one wave of
    ``_TARGET_BLOCKS`` holds, at least one k16 step per warp."""
    tiles = -(-N // _COLS)
    return max(1, min(_TARGET_BLOCKS // tiles, (K // 16) // _WARPS))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mp_int8_gemv_kn": [_P] * 5 + [_I] * 5 + [_P],
    "mp_int8_gemv_nk": [_P] * 4 + [_I] * 4 + [_P],
}


def _entry(name: str):
    lib = build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def int8_gemv(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
              k_major: bool = False) -> torch.Tensor:
    """``(h @ q) * scale`` (or ``(h @ q.T) * scale`` with ``k_major``) over
    the last axis of ``h``; leading axes of ``h`` are kept."""
    devs = {h.device.type, q.device.type, scale.device.type}
    if devs == {"cpu"}:
        return int8_gemv_plain(h, q, scale, k_major)
    _require(devs == {"cuda"}, f"int8_gemv takes tensors all on cpu or all on cuda, got {devs}")
    _require(h.dtype == torch.bfloat16, f"h must be bfloat16, got {h.dtype}")
    _require(q.dtype == torch.int8 and q.ndim == 2 and q.is_contiguous(),
             "q must be a contiguous 2-D int8 tensor")
    N, K = (q.shape[0], q.shape[1]) if k_major else (q.shape[1], q.shape[0])
    _require(h.shape[-1] == K, f"h has {h.shape[-1]} features, the weight {K}")
    _require(scale.dtype == torch.float32 and scale.shape == (N,) and scale.is_contiguous(),
             "scale must be contiguous fp32 (N,)")
    h2 = h.reshape(-1, K)
    if not h2.is_contiguous() or h2.data_ptr() % 16:
        h2 = h2.contiguous()
    M = h2.shape[0]
    _require(1 <= M <= MAX_ROWS, f"int8_gemv takes 1 to {MAX_ROWS} rows, got {M}")
    _require(q.data_ptr() % 16 == 0 and h2.data_ptr() % 16 == 0, "operands must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32 if k_major else torch.bfloat16, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        if k_major:
            lib, fn = _entry("mp_int8_gemv_nk")
            status = fn(h2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        M, K, N, 1, stream)
        else:
            splits = k_splits(K, N)
            part = (torch.empty((splits, M, N), dtype=torch.float32, device=h.device)
                    if splits > 1 else None)
            lib, fn = _entry("mp_int8_gemv_kn")
            status = fn(h2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        0 if part is None else part.data_ptr(), M, K, N, splits, 0, stream)
    if status != 0:
        raise RuntimeError(f"int8_gemv launch failed: {lib.mp_error_string(status).decode()}")
    LAUNCHES["int8_gemv"] += 1
    return out.reshape(*h.shape[:-1], N)
