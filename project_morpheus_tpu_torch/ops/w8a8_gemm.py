"""The chunk prefill's w8a8 projections (CUDA, ``csrc/w8a8_gemm.cu``).

Two kernels: :func:`quantize_rows` turns each token's activations into
int8 with one fp32 scale a row, and :func:`w8a8_gemm` multiplies those
int8 rows by an int8 weight with int32 sums and applies both scales in
its epilogue, writing the activation dtype:

    hsc = max(max_k |h[m, k]|, 1e-8) / 127          (IEEE division)
    h8  = int8(clamp(round_half_even(h / hsc), -127, 127))
    y   = out_dtype((float32(h8 @ q) * hsc[m]) * scale[n])

Not a port of a Pallas kernel: it does what XLA does for the JAX package's
``matmul_w8a8`` (``project_morpheus_tpu/model/quant.py:84-95``, the
quantization and an int8 ``dot_general`` with int32 accumulation), which
the chunk prefill runs on every projection by default.  Bound: at a
prefill round's rows the GEMM is bound by operations (2MKN at 1,979 dense
int8 TOP/s); at 128 rows or fewer by the weight's bytes; the quantize by
bytes.  The GEMM runs wgmma on TMA-fed tiles, which takes 8-bit operands
K-major only, so it reads the weight from its K-major copy ``qt`` (N, K)
(``model/quant.py: add_k_major_copies``); its tile width (128 or 256
columns) is chosen here from the grid it gives on the card's SMs.  The
source's header gives the design.

Every step is exact or correctly rounded, so the kernels equal their
plain versions bit for bit.  The plain versions divide by a tensor, not a
Python number: PyTorch's CUDA division by a number multiplies by its
reciprocal, which rounds differently.  On a CPU tensor the wrappers run
the plain versions; on a CUDA tensor they launch the kernels or raise.
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from . import build

SOURCE = "w8a8_gemm.cu"
TILE_M, TILE_K = 128, 128  # rows and K of a block's tile
TILE_N = (256, 128)        # the column widths the GEMM takes

LAUNCHES = {"w8a8_quantize": 0, "w8a8_gemm": 0}

Amax = Optional[Callable[[torch.Tensor], torch.Tensor]]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def quantize_rows_plain(h: torch.Tensor, amax: Amax = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 of ``h`` (..., K): ``(h8, hsc)`` with ``hsc`` (..., 1)
    fp32.  ``amax`` maps the rows' absolute maxima (..., 1) to those of the
    whole row (a tensor-parallel rank holds part of a row-split input)."""
    hf = h.float()
    peak = hf.abs().amax(dim=-1, keepdim=True)
    if amax is not None:
        peak = amax(peak)
    hsc = torch.clamp(peak, min=1e-8) / peak.new_tensor(127.0)
    h8 = torch.clamp(torch.round(hf / hsc), -127, 127).to(torch.int8)
    return h8, hsc


def w8a8_gemm_plain(h8: torch.Tensor, hsc: torch.Tensor, qt: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """``((h8 @ qt.T) * hsc) * scale`` in ``out_dtype``: the int32 product
    exact (``model/quant.py: _int8_matmul``), the scales in fp32."""
    from ..model.quant import _int8_matmul

    K = h8.shape[-1]
    y32 = _int8_matmul(h8.reshape(-1, K), qt.T).reshape(*h8.shape[:-1], qt.shape[0])
    return (y32.float() * hsc.reshape(*h8.shape[:-1], 1) * scale).to(out_dtype)


def block_n(M: int, N: int, sms: int) -> int:
    """The GEMM's tile width: 256 columns unless 128-wide tiles fill the
    ``sms`` SMs in fewer waves of the same work (a 256-wide tile does twice
    a 128-wide one's), with 15% given to the wider tile, which loads fewer
    bytes an operation."""
    if N % 256:
        return 128
    rows = -(-M // TILE_M)
    waves = {bn: -(-(rows * N // bn) // sms) for bn in TILE_N}
    return 256 if 2 * waves[256] <= 1.15 * waves[128] else 128


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mp_w8a8_gemm": [_P] * 5 + [_I] * 5 + [_P],
    "mp_w8a8_quantize": [_P, _I, _I, _I] + [_P] * 5,
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


def _check(lib, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed: {lib.mp_error_string(status).decode()}")


def _on_card(*ts: torch.Tensor) -> bool:
    """False for tensors all on the CPU, True for all on one CUDA device;
    raises for anything else."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return False
    _require(len(devs) == 1 and next(iter(devs)).type == "cuda",
             f"w8a8 kernels take tensors all on the cpu or all on one cuda device, got {devs}")
    return True


def _rows(t: torch.Tensor, K: int) -> torch.Tensor:
    t2 = t.reshape(-1, K)
    return t2 if t2.is_contiguous() and t2.data_ptr() % 16 == 0 else t2.contiguous()


def quantize_rows(h: torch.Tensor, amax: Amax = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_plain` on the card: one launch, or with
    ``amax`` two (the rows' maxima, then the rows from ``amax`` of them)."""
    if not _on_card(h):
        return quantize_rows_plain(h, amax)
    _require(h.dtype in (torch.bfloat16, torch.float32),
             f"h must be bfloat16 or float32, got {h.dtype}")
    K = h.shape[-1]
    _require(K > 0 and K % 16 == 0, f"quantize_rows takes K a multiple of 16, got {K}")
    h2 = _rows(h, K)
    M = h2.shape[0]
    _require(M >= 1, "quantize_rows takes at least one row")
    lib, fn = _entry("mp_w8a8_quantize")
    stream = torch.cuda.current_stream(h.device).cuda_stream
    in_f32 = int(h.dtype == torch.float32)
    h8 = torch.empty((M, K), dtype=torch.int8, device=h.device)
    hsc = torch.empty((M, 1), dtype=torch.float32, device=h.device)
    peak_ptr = None
    with torch.cuda.device(h.device):
        if amax is not None:
            peak = torch.empty((M, 1), dtype=torch.float32, device=h.device)
            _check(lib, fn(h2.data_ptr(), M, K, in_f32, None, peak.data_ptr(), None, None,
                           stream), "w8a8 quantize (peak)")
            LAUNCHES["w8a8_quantize"] += 1
            peak = amax(peak.reshape(*h.shape[:-1], 1))
            _require(peak.dtype == torch.float32 and peak.device == h.device
                     and peak.numel() == M, "amax must return the fp32 maxima, one a row")
            peak = peak.reshape(M).contiguous()
            peak_ptr = peak.data_ptr()
        _check(lib, fn(h2.data_ptr(), M, K, in_f32, peak_ptr, None, h8.data_ptr(),
                       hsc.data_ptr(), stream), "w8a8 quantize")
    LAUNCHES["w8a8_quantize"] += 1
    return h8.reshape(h.shape), hsc.reshape(*h.shape[:-1], 1)


def w8a8_gemm(h8: torch.Tensor, hsc: torch.Tensor, qt: torch.Tensor, scale: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``((h8 @ qt.T) * hsc) * scale`` in ``out_dtype`` over the last axis
    of ``h8`` (..., K), for the weight's K-major copy ``qt`` (N, K);
    ``hsc`` holds one scale a row of ``h8``."""
    if not _on_card(h8, hsc, qt, scale):
        return w8a8_gemm_plain(h8, hsc, qt, scale, out_dtype)
    _require(h8.dtype == torch.int8, f"h8 must be int8, got {h8.dtype}")
    _require(qt.dtype == torch.int8 and qt.ndim == 2 and qt.is_contiguous()
             and qt.data_ptr() % 16 == 0, "qt must be a contiguous, 16-byte aligned 2-D int8 tensor")
    N, K = qt.shape
    _require(h8.shape[-1] == K, f"h8 has {h8.shape[-1]} features, the weight {K}")
    _require(K % TILE_K == 0 and N % min(TILE_N) == 0,
             f"w8a8_gemm takes K and N multiples of {TILE_K}, got K={K}, N={N}")
    _require(scale.dtype == torch.float32 and scale.shape == (N,) and scale.is_contiguous()
             and scale.data_ptr() % 8 == 0, "scale must be contiguous fp32 (N,)")
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    h2 = _rows(h8, K)
    M = h2.shape[0]
    _require(M >= 1, "w8a8_gemm takes at least one row")
    _require(hsc.dtype == torch.float32 and hsc.numel() == M and hsc.is_contiguous(),
             "hsc must be contiguous fp32, one scale a row")
    bn = block_n(M, N, _sm_count(h8.device))
    out = torch.empty((M, N), dtype=out_dtype, device=h8.device)
    lib, fn = _entry("mp_w8a8_gemm")
    stream = torch.cuda.current_stream(h8.device).cuda_stream
    with torch.cuda.device(h8.device):
        status = fn(h2.data_ptr(), qt.data_ptr(), hsc.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), M, N, K, bn, int(out_dtype == torch.float32), stream)
    _check(lib, status, "w8a8_gemm")
    LAUNCHES["w8a8_gemm"] += 1
    return out.reshape(*h8.shape[:-1], N)
