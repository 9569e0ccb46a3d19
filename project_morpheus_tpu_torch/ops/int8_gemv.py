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
the source).  The kernel streams weight tiles through a shared-memory ring
by TMA, starting before the previous kernel has finished (a programmatic
dependent launch), and in the ``(K, N)`` layout sums its K split inside a
thread-block cluster of ``k_splits`` blocks; the ``(N, K)`` layout runs
``nk_blocks`` persistent blocks.  Both counts are planned here, in plain
Python, from the card's SM count
(``torch.cuda.get_device_properties(...).multi_processor_count``).

The weights (``q`` and ``scale``) are read before the kernel launched just
before the call has finished, so that kernel must not write them; a
model's weights are written once, when it is loaded.

On a CPU tensor the wrapper runs the plain twin, the math of
``model/quant.py``; on a CUDA tensor it launches the kernel or raises.  The
kernel accumulates in fp32 in a fixed order and rounds once, where the twin
rounds to bf16 three times (the product, the scale, the scaled output):
they differ by up to about two bf16 ulps of the output (2**-6 relative
bounds it).  ``LAUNCHES`` counts wrapper calls that launched it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "int8_gemv.cu"
MAX_ROWS = 16
# (K, N) layout: columns of a cluster's tile, k rows of a ring stage, and
# the cluster sizes the kernel takes
_COLS, _STAGE_K, _CLUSTERS = 128, 128, (8, 4, 2, 1)
# (N, K) layout: table rows of a tile
_TILE_ROWS = 64

LAUNCHES = {"int8_gemv": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def int8_gemv_plain(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    k_major: bool = False) -> torch.Tensor:
    """Plain twin: the dequant-then-matmul of ``model/quant.py``."""
    from ..model.quant import dequant_matmul, dequant_matmul_t

    return dequant_matmul_t(h, q, scale) if k_major else dequant_matmul(h, q, scale)


def k_splits(K: int, N: int, sms: int) -> int:
    """Blocks of a cluster along K for the (K, N) layout: the largest of 8,
    4, 2, 1 whose grid (``ceil(N / 128)`` clusters) has at most one block
    for each of ``sms`` SMs, every block with at least one 128-row stage of
    K; 1 where even that grid has more blocks than SMs."""
    tiles, stages = -(-N // _COLS), -(-K // _STAGE_K)
    for cs in _CLUSTERS:
        if cs <= stages and tiles * cs <= sms:
            return cs
    return 1


def nk_blocks(N: int, sms: int) -> int:
    """Persistent blocks for the (N, K) layout: one a SM, at most one a
    64-row tile of the table."""
    return max(1, min(sms, -(-N // _TILE_ROWS)))


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mp_int8_gemv_kn": [_P] * 4 + [_I] * 4 + [_P],
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
    sms = _sm_count(h.device)
    with torch.cuda.device(h.device):
        if k_major:
            lib, fn = _entry("mp_int8_gemv_nk")
            count = nk_blocks(N, sms)
        else:
            lib, fn = _entry("mp_int8_gemv_kn")
            count = k_splits(K, N, sms)
        status = fn(h2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                    M, K, N, count, stream)
    if status != 0:
        raise RuntimeError(f"int8_gemv launch failed: {lib.mp_error_string(status).decode()}")
    LAUNCHES["int8_gemv"] += 1
    return out.reshape(*h.shape[:-1], N)
