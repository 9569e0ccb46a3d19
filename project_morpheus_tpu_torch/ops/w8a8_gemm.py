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
(``model/quant.py: add_k_major_copies``).  It takes any N and any K that
is a multiple of 16 (TMA's row stride; the quantize needs it too).
:func:`gemm_plan` chooses its tile and its split of K across a cluster of
blocks from the grid they give on the card's SMs, and on at most
``SHORT_ROWS`` rows the GEMM is launched as a programmatic dependent of
the kernel before it (the quantize), so its launch and its first weight
tiles overlap that kernel.  The source's header gives the design.

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
TILE_M, TILE_K = 128, 128  # rows and K of a block's tile from 129 rows up
TILE_N = (256, 128)        # the column widths from 129 rows up
SHORT_ROWS = 128           # up to here a call is bound by the weight's bytes
SHORT_TILE_N = (128, 96)   # the column widths of a short call
SPLITS = (1, 2, 4, 8)      # blocks of a cluster that split K
PREFETCH_ALL = 8           # the most early weight tiles a call can ask for: a ring
SHORT_PREFETCH = 2         # a short call's early weight tiles (measured best of 0, 2, all)
# launch a short call's GEMM as a programmatic dependent of the kernel
# before it (from 129 rows up the pair measured no gain, some shapes a loss)
DEPENDENT_LAUNCH = True

# launches of each kernel, and (``_short``) those of them on at most
# SHORT_ROWS rows: the short prompts' rounds
LAUNCHES = {"w8a8_quantize": 0, "w8a8_gemm": 0, "w8a8_quantize_short": 0, "w8a8_gemm_short": 0}

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


Clusters = Optional[Callable[[int, int, int], int]]

# A short call's time, as kernel_ablation w8a8 measured it on an H100 80GB
# HBM3 at 700 W (PERF.md, Findings): one block streams weight bytes at
# ~67.5 GB/s and activation bytes (L2-resident) at ~134 GB/s, all blocks
# together at most ~2.8 TB/s, and a split's cluster reduction adds ~1.8 us.
BLOCK_WEIGHT_BYTES_PER_S = 67.5e9
BLOCK_ROW_BYTES_PER_S = 134e9
CARD_BYTES_PER_S = 2.8e12
SPLIT_S = 1.8e-6


def short_call_s(M: int, N: int, K: int, bm: int, bn: int, splits: int, sms: int) -> float:
    """Estimated seconds of a short call under a plan: the slower of one
    block's share (its wave count times its weight and activation bytes at
    a block's rates) and the card's (all the bytes at its rate, stretched
    by a last partial wave), plus the split's reduction."""
    blocks = -(-M // bm) * -(-N // bn) * splits
    waves = -(-blocks // sms)
    k = K / splits
    block_s = waves * k * (bn / BLOCK_WEIGHT_BYTES_PER_S + min(M, bm) / BLOCK_ROW_BYTES_PER_S)
    card_s = (K * N + M * K) / CARD_BYTES_PER_S * (waves * sms / blocks if waves > 1 else 1.0)
    return max(block_s, card_s) + (SPLIT_S if splits > 1 else 0.0)


def gemm_plan(M: int, N: int, K: int, sms: int,
              clusters: Clusters = None) -> Tuple[int, int, int, int]:
    """The GEMM's (tile rows, tile columns, blocks splitting K, weight
    tiles requested before the kernel ahead ends) for an (M, K) x (K, N)
    product on ``sms`` SMs.  From 129 rows up: 128-row tiles,
    :func:`block_n`, no split, no early weight tiles (an activation tile
    queued behind them would hold the first product back).  Up to 128 rows
    the weight's bytes bound the call: 64-row tiles up to 64 rows, and the
    column width (128 or 96) and split of K (1, 2, 4 or 8 blocks, each with
    at least one 128-deep K tile and an equal share of the tile's column
    groups, the grid in one wave and every cluster resident at once, by
    ``clusters(tile rows, tile columns, split)`` where given) with the least
    :func:`short_call_s`, the one with more blocks and then the wider tile
    on a tie; two weight tiles early (the whole ring would queue the first
    activation tile behind it)."""
    if M > SHORT_ROWS:
        return TILE_M, block_n(M, N, sms), 1, 0
    bm = 64 if M <= 64 else 128
    k_tiles = -(-K // TILE_K)
    best = None
    for bn in SHORT_TILE_N:
        tiles = -(-N // bn)
        for cs in SPLITS:
            if cs > 1 and ((bn // 8) % cs or cs > k_tiles or tiles * cs > sms
                           or (clusters is not None and tiles > clusters(bm, bn, cs))):
                continue
            key = (-short_call_s(M, N, K, bm, bn, cs, sms), tiles * cs, bn)
            if best is None or key > best[0]:
                best = (key, bn, cs)
    return bm, best[1], best[2], SHORT_PREFETCH


_SMS: dict = {}
_CLUSTERS: dict = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def max_clusters(device: torch.device, bm: int, bn: int, splits: int) -> int:
    """Clusters of ``splits`` blocks of the ``bm`` x ``bn`` GEMM that the
    card holds at once (``cudaOccupancyMaxActiveClusters``; a cluster's
    blocks share a GPC, whose SMs a cluster size may not divide)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, bm, bn, splits)
    if key not in _CLUSTERS:
        lib, fn = _entry("mp_w8a8_gemm_max_clusters")
        with torch.cuda.device(idx):
            n = fn(bm, bn, splits)
        if n < 0:
            raise RuntimeError(f"w8a8_gemm cluster occupancy query failed ({n})")
        _CLUSTERS[key] = n
    return _CLUSTERS[key]


def card_plan(M: int, N: int, K: int, device: torch.device) -> Tuple[int, int, int, int]:
    """:func:`gemm_plan` with this card's SMs and cluster occupancy."""
    return gemm_plan(M, N, K, _sm_count(device),
                     lambda bm, bn, cs: max_clusters(device, bm, bn, cs))


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mp_w8a8_gemm": [_P] * 5 + [_I] * 9 + [_P],
    "mp_w8a8_gemm_max_clusters": [_I] * 3,
    "mp_w8a8_quantize": [_P, _I, _I, _I] + [_P] * 5,
}


def _entry(name: str):
    lib = build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _count(kernel: str, M: int) -> None:
    LAUNCHES[kernel] += 1
    if M <= SHORT_ROWS:
        LAUNCHES[kernel + "_short"] += 1


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
            _count("w8a8_quantize", M)
            peak = amax(peak.reshape(*h.shape[:-1], 1))
            _require(peak.dtype == torch.float32 and peak.device == h.device
                     and peak.numel() == M, "amax must return the fp32 maxima, one a row")
            peak = peak.reshape(M).contiguous()
            peak_ptr = peak.data_ptr()
        _check(lib, fn(h2.data_ptr(), M, K, in_f32, peak_ptr, None, h8.data_ptr(),
                       hsc.data_ptr(), stream), "w8a8 quantize")
    _count("w8a8_quantize", M)
    return h8.reshape(h.shape), hsc.reshape(*h.shape[:-1], 1)


def w8a8_gemm(h8: torch.Tensor, hsc: torch.Tensor, qt: torch.Tensor, scale: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """``((h8 @ qt.T) * hsc) * scale`` in ``out_dtype`` over the last axis
    of ``h8`` (..., K), for the weight's K-major copy ``qt`` (N, K);
    ``hsc`` holds one scale a row of ``h8``.  Any N; K a multiple of 16."""
    if not _on_card(h8, hsc, qt, scale):
        return w8a8_gemm_plain(h8, hsc, qt, scale, out_dtype)
    _require(h8.dtype == torch.int8, f"h8 must be int8, got {h8.dtype}")
    _require(qt.dtype == torch.int8 and qt.ndim == 2 and qt.is_contiguous()
             and qt.data_ptr() % 16 == 0, "qt must be a contiguous, 16-byte aligned 2-D int8 tensor")
    N, K = qt.shape
    _require(h8.shape[-1] == K, f"h8 has {h8.shape[-1]} features, the weight {K}")
    _require(K > 0 and K % 16 == 0 and N > 0,
             f"w8a8_gemm takes K a multiple of 16 (TMA's row stride), got K={K}, N={N}")
    _require(scale.dtype == torch.float32 and scale.shape == (N,) and scale.is_contiguous(),
             "scale must be contiguous fp32 (N,)")
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    h2 = _rows(h8, K)
    M = h2.shape[0]
    _require(M >= 1, "w8a8_gemm takes at least one row")
    _require(hsc.dtype == torch.float32 and hsc.numel() == M and hsc.is_contiguous(),
             "hsc must be contiguous fp32, one scale a row")
    bm, bn, splits, prefetch = PLAN(M, N, K, h8.device)
    out = torch.empty((M, N), dtype=out_dtype, device=h8.device)
    lib, fn = _entry("mp_w8a8_gemm")
    stream = torch.cuda.current_stream(h8.device).cuda_stream
    with torch.cuda.device(h8.device):
        status = fn(h2.data_ptr(), qt.data_ptr(), hsc.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), M, N, K, bm, bn, splits, prefetch,
                    int(DEPENDENT_LAUNCH and M <= SHORT_ROWS), int(out_dtype == torch.float32),
                    stream)
    _check(lib, status, "w8a8_gemm")
    _count("w8a8_gemm", M)
    return out.reshape(*h8.shape[:-1], N)


# the planner the wrapper asks, (M, N, K, device) -> plan; a tool may put
# another in its place to time other plans
PLAN = card_plan
