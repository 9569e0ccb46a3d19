"""The decode step's elementwise chain as three kernels (CUDA,
``csrc/decode_trunk.cu``).

Between its int8 GEMV calls a decode step of ``model/llama.py`` adds the
residual, normalises, rotates q and k, writes the cache and gates the MLP.
As PyTorch ops that was ~46 launches a layer and step; here it is four:

- :func:`add_rmsnorm`: ``x <- x + d`` in place (bf16), returns
  ``rmsnorm(x, w, eps)``; without ``d``, the norm alone (the first layer's
  ``ln1``).  The MLP's add of one layer goes into the next layer's ``ln1``,
  the last one into ``ln_f``.
- :func:`rope_kv_write`: from the fused ``wqkv`` output, the rotated q as
  ``(B, H, HD)`` (the decode attention's input), and the rotated k and the
  v written into one layer of the head-major bf16 cache at ``lengths[b]``.
- :func:`swiglu`: ``silu(g) * u`` of the fused ``wgu`` output.

Not a port of a Pallas kernel: XLA fuses this chain for the JAX package.
Bound: device-memory bytes, a few hundred KB a call (``csrc`` has the
design).  Each wrapper takes 1 to ``MAX_ROWS`` rows of bf16 (the decode
step's slots) and raises on anything else, on the CPU too.  On CPU tensors
it runs its plain twin, which is the decode step's own plain path (the
step calls the twins where it does not take the kernels), so the CPU gets
the same bits either way; on CUDA tensors it launches its kernel, which
rounds where those ops round (the norm's sum of squares is taken in
another order: at most an ulp of fp32 before the bf16 rounding).
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

SOURCE = "decode_trunk.cu"
MAX_ROWS = 16
MAX_NORM_WIDTH = 8192  # one block a row, one 8-value piece a thread

LAUNCHES = {"add_rmsnorm": 0, "rope_kv_write": 0, "swiglu": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def norm_supported(width: int) -> bool:
    return width % 8 == 0 and 8 <= width <= MAX_NORM_WIDTH


def rope_supported(head_dim: int) -> bool:
    return head_dim % 16 == 0 and head_dim >= 16


def swiglu_supported(width: int) -> bool:
    return width % 8 == 0 and width >= 8


# ------------------------------------------------------------- plain twins


def add_rmsnorm_plain(x: torch.Tensor, d: Optional[torch.Tensor], w: torch.Tensor,
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + d, rmsnorm(x + d, w, eps))``; without ``d``, ``(x, rmsnorm(x,
    w, eps))``.  Nothing is written in place."""
    from ..model.llama import rmsnorm

    if d is not None:
        x = x + d
    return x, rmsnorm(x, w, eps)


def split_qkv(qkv: torch.Tensor, kv_heads: int, head_dim: int):
    """The fused ``wqkv`` output ``(B, [1,] (H + 2KV) HD)`` as views q, k
    and v, ``(B, 1, heads, HD)`` each."""
    heads = qkv.reshape(qkv.shape[0], 1, -1, head_dim)
    return heads.split([heads.shape[2] - 2 * kv_heads, kv_heads, kv_heads], dim=2)


def rope_kv_write_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, inv_freqs: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, layer: int) -> torch.Tensor:
    """q, k and v ``(B, 1, heads, HD)``: returns q rotated by ``lengths[b]``
    as ``(B, H, HD)`` and writes k rotated and v, cast to the cache's
    dtype, at ``[layer, b, :, lengths[b]]`` of the head-major caches (one
    indexed write per tensor; a position past the capacity raises)."""
    from ..model.llama import apply_rope

    positions = lengths[:, None]
    q = apply_rope(q, positions, inv_freqs)
    k = apply_rope(k, positions, inv_freqs)
    slots, pos = torch.arange(q.shape[0], device=q.device), lengths.long()
    cache_k[layer, slots, :, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[layer, slots, :, pos] = v[:, 0].to(cache_v.dtype)
    return q[:, 0].contiguous()


def swiglu_plain(gu: torch.Tensor, width: int) -> torch.Tensor:
    """``silu(gu[..., :width]) * gu[..., width:]``."""
    return torch.nn.functional.silu(gu[..., :width]) * gu[..., width:]


# ---------------------------------------------------------------- wrappers


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mp_add_rmsnorm": [_P] * 4 + [_I, _I, _F, _P],
    "mp_rope_kv_write": [_P] * 6 + [_I] * 5 + [_P],
    "mp_swiglu": [_P, _P, _I, _I, _P],
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


def _on_cpu(name: str, *tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    _require(devs in ({"cpu"}, {"cuda"}),
             f"{name} takes tensors all on cpu or all on cuda, got {devs}")
    return devs == {"cpu"}


def _check_rows(name: str, *tensors) -> None:
    """bf16, contiguous, 16-byte aligned, rows on the leading axes."""
    for t in tensors:
        if t is None:
            continue
        _require(t.dtype == torch.bfloat16, f"{name} takes bfloat16, got {t.dtype}")
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name} takes contiguous 16-byte aligned tensors")


def _rows(name: str, t: torch.Tensor) -> int:
    rows = t.numel() // t.shape[-1]
    _require(1 <= rows <= MAX_ROWS, f"{name} takes 1 to {MAX_ROWS} rows, got {rows}")
    return rows


def _launch(name: str, *args) -> None:
    lib, fn = _entry(f"mp_{name}")
    status = fn(*args)
    if status != 0:
        raise RuntimeError(f"{name} launch failed: {lib.mp_error_string(status).decode()}")
    LAUNCHES[name] += 1


def add_rmsnorm(x: torch.Tensor, d: Optional[torch.Tensor], w: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``x += d`` in place (where ``d`` is given), then ``rmsnorm(x, w,
    eps)``: ``x`` and ``d`` ``(..., D)`` bf16, ``w`` ``(D,)`` bf16."""
    cpu = _on_cpu("add_rmsnorm", x, d, w)
    _check_rows("add_rmsnorm", x, d, w)
    D = x.shape[-1]
    _require(norm_supported(D), f"add_rmsnorm takes D % 8 == 0 up to {MAX_NORM_WIDTH}, got {D}")
    _require(w.shape == (D,), f"w must be ({D},), got {tuple(w.shape)}")
    _require(d is None or d.shape == x.shape, "d must have x's shape")
    rows = _rows("add_rmsnorm", x)
    if cpu:
        xd, h = add_rmsnorm_plain(x, d, w, eps)
        if d is not None:
            x.copy_(xd)
        return h
    h = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("add_rmsnorm", x.data_ptr(), 0 if d is None else d.data_ptr(), w.data_ptr(),
                h.data_ptr(), rows, D, eps, torch.cuda.current_stream(x.device).cuda_stream)
    return h


def rope_kv_write(qkv: torch.Tensor, lengths: torch.Tensor, inv_freqs: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int) -> torch.Tensor:
    """The fused ``wqkv`` output ``(B, [1,] (H + 2KV) HD)``: returns q
    rotated by ``lengths[b]`` as ``(B, H, HD)`` and writes k rotated and v
    at ``[layer, b, :, lengths[b]]`` of the head-major ``(L, B, KV, S, HD)``
    bf16 caches; ``inv_freqs`` ``(HD / 2,)`` fp32, ``lengths`` ``(B,)``
    int32.  A position past the capacity is not written on the card (the
    plain twin raises; the decode step's callers keep every slot's length
    below it: ``model/llama.py``)."""
    cpu = _on_cpu("rope_kv_write", qkv, lengths, inv_freqs, cache_k, cache_v)
    _check_rows("rope_kv_write", qkv, cache_k, cache_v)
    _require(cache_k.ndim == 5 and cache_v.shape == cache_k.shape,
             "rope_kv_write takes head-major (L, B, KV, S, HD) k and v caches")
    L, B, KV, S, HD = cache_k.shape
    _require(rope_supported(HD), f"rope_kv_write takes HD % 16 == 0, got {HD}")
    N = qkv.shape[-1]
    _require(N % HD == 0 and N // HD > 2 * KV, "qkv is not q, k and v heads of the cache's HD")
    _require(_rows("rope_kv_write", qkv) == B, "qkv and the cache disagree on the slot count")
    _require(lengths.dtype == torch.int32 and lengths.shape == (B,) and lengths.is_contiguous(),
             "lengths must be contiguous int32 (B,)")
    _require(inv_freqs.dtype == torch.float32 and inv_freqs.shape == (HD // 2,)
             and inv_freqs.is_contiguous(), f"inv_freqs must be contiguous fp32 ({HD // 2},)")
    _require(0 <= int(layer) < L, f"layer {layer} out of range [0, {L})")
    if cpu:
        return rope_kv_write_plain(*split_qkv(qkv, KV, HD), lengths, inv_freqs, cache_k,
                                   cache_v, layer)
    H = N // HD - 2 * KV
    q = torch.empty((B, H, HD), dtype=torch.bfloat16, device=qkv.device)
    with torch.cuda.device(qkv.device):
        _launch("rope_kv_write", qkv.data_ptr(), lengths.data_ptr(), inv_freqs.data_ptr(),
                q.data_ptr(), cache_k[layer].data_ptr(), cache_v[layer].data_ptr(), B, H, KV, HD,
                S, torch.cuda.current_stream(qkv.device).cuda_stream)
    return q


def swiglu(gu: torch.Tensor, width: int) -> torch.Tensor:
    """``silu(gu[..., :width]) * gu[..., width:]`` of the fused ``wgu``
    output ``(..., 2 * width)`` bf16."""
    cpu = _on_cpu("swiglu", gu)
    _check_rows("swiglu", gu)
    _require(swiglu_supported(width) and gu.shape[-1] == 2 * width,
             f"swiglu takes (..., 2F) with F % 8 == 0, got F = {width}, {tuple(gu.shape)}")
    rows = _rows("swiglu", gu)
    if cpu:
        return swiglu_plain(gu, width)
    act = torch.empty((*gu.shape[:-1], width), dtype=torch.bfloat16, device=gu.device)
    with torch.cuda.device(gu.device):
        _launch("swiglu", gu.data_ptr(), act.data_ptr(), rows, width,
                torch.cuda.current_stream(gu.device).cuda_stream)
    return act
