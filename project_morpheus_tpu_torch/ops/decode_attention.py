"""Length-aware flash decode attention over the slot KV cache (CUDA).

Port of the three Pallas TPU kernels of the JAX package's
``ops/decode_attention.py`` to two CUDA C++ kernels for Hopper
(``csrc/``, built by ``ops/build.py``):

- :func:`decode_attention_int8_slots` replaces ``_slot_attn_kernel``
  (``pallas_call`` at decode_attention.py:628/:648): the production decode
  attention over the flat position-major int8 cache ``(L, B, S, KV*HD)``
  with scales ``(L, B, S, 2KV)``.
- :func:`decode_attention_layered` replaces ``_decode_attn_kernel_layered``
  (:348): the same over the head-major ``(L, B, KV, S, HD)`` cache, bf16
  or int8 with ``(L, B, KV, S)`` scales.
- :func:`decode_attention` replaces ``_decode_attn_kernel`` (:701): one
  layer ``(B, KV, S, HD)``, i.e. the layered kernel with ``L = 1``.

Queries are GQA-grouped ``(B, H, HD)``: heads ``[h*G, (h+1)*G)`` attend kv
head ``h``.  ``lengths[b]`` counts the live positions of slot ``b``; the
output is ``acc / max(l, 1e-30)`` of an online softmax over them, so a
slot of length 0 yields zeros (as the Pallas kernels do, where the dense
oracle would give the mean of V).

Bound: each call reads every live K/V position of one layer once, so it is
bound by device-memory bytes: at 8 slots x 8192 live positions of the 3B
int8 cache, 65,536 x (2 x 1024 + 64) B = 138 MB, 41 us at the H100 SXM data
sheet's 3.35 TB/s.  Design against that bound: a grid of (kv head, split,
slot) blocks, each streaming up to ``SPLIT_LEN`` positions of one slot
through a shared-memory ring of cp.async tiles for the G query rows of one
kv head, scores on tensor cores, blocks past a slot's live length exiting
at once, the grid capped at ``SPLIT_BLOCKS_PER_SM`` blocks an SM (past
that a block strides over its slot's live splits); a second small kernel
merges the splits (see
``csrc/flash_decode.cuh``).  Both kernels attend ``min(lengths[b], S)``
positions, as the twins do.

Each wrapper sends a CPU tensor to its plain PyTorch twin in this module
and launches its kernel for a CUDA tensor, or raises: nothing falls back.
``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

# positions each block streams, a whole number of the kernels' 128-position
# tiles; blocks past a slot's live length exit
SPLIT_LEN = 512

# kernel launches per wrapper (never counts a plain-twin call)
LAUNCHES = {"decode_attention_layered": 0, "decode_attention_int8_slots": 0}

# the most blocks an SM a call's split grid holds: a block past its slot's
# live length exits at once but still costs a launch, so past this count a
# block strides over several live splits of its slot
SPLIT_BLOCKS_PER_SM = 8


def flash_decode_supported(head_dim: int, group: int) -> bool:
    """Whether the CUDA kernels take queries of ``head_dim`` in GQA groups
    of ``group`` query heads a kv head: head dims 64 and 128, groups of 1
    to 4, as ``launch_flash_decode`` in csrc/flash_decode.cuh instantiates
    them (the twins take any shape)."""
    return head_dim in (64, 128) and 1 <= group <= 4


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- plain twins


def decode_attention_reference(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """The JAX package's dense oracle: q (B,H,HD), k/v (B,KV,S,HD), lengths
    (B,).  Scores in fp32 times HD**-0.5, positions at or past ``lengths``
    at -1e30, softmax, probabilities cast to V's dtype and accumulated in
    fp32, the output in q's dtype.  A slot of length 0 gives the mean of V
    (the kernels and their twins give zeros there)."""
    B, H, HD = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, HD)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(), k_cache.float()) * HD**-0.5
    live = torch.arange(S, device=q.device)[None, :] < lengths[:, None].long()
    scores = torch.where(live[:, None, None, :], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs.float(), v_cache.float())
    return out.reshape(B, H, HD).to(q.dtype)



def _flash_plain(q, k, v, k_scale, v_scale, lengths) -> torch.Tensor:
    """Dense fp32 twin of the flash kernels: q (B,H,HD), k/v (B,KV,S,HD),
    optional per-position scales (B,KV,S); zeros for a length-0 slot."""
    B, H, HD = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, HD) * HD**-0.5
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float())
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]  # k dequant applied to scores
    live = (torch.arange(S, device=q.device)[None, :] < lengths[:, None].long())
    live = live[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * live
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]  # v dequant folded into probs
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, H, HD)


def decode_attention_layered_plain(q, k_cache, v_cache, lengths, layer,
                                   k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain twin of :func:`decode_attention_layered` (output in q.dtype)."""
    out = _flash_plain(
        q, k_cache[layer], v_cache[layer],
        None if k_scale is None else k_scale[layer],
        None if v_scale is None else v_scale[layer],
        lengths,
    )
    return out.to(q.dtype)


def decode_attention_int8_slots_plain(q, k_cache, v_cache, kv_scale, lengths,
                                      layer) -> torch.Tensor:
    """Plain twin of :func:`decode_attention_int8_slots` (output in q.dtype)."""
    _, B, S, DKV = k_cache.shape
    HD = q.shape[-1]
    KV = DKV // HD
    k = k_cache[layer].reshape(B, S, KV, HD).transpose(1, 2)
    v = v_cache[layer].reshape(B, S, KV, HD).transpose(1, 2)
    sc = kv_scale[layer]
    out = _flash_plain(
        q, k, v, sc[..., :KV].transpose(1, 2), sc[..., KV:].transpose(1, 2),
        lengths,
    )
    return out.to(q.dtype)


# ---------------------------------------------------------------- wrappers


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"decode attention takes tensors all on cpu or all on cuda, got {devs}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(q, lengths, B, KV):
    _require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    _require(q.is_contiguous(), "q must be contiguous")
    _require(q.shape[0] == B, "q and cache disagree on the slot count")
    _require(q.shape[1] % KV == 0, "query heads must be a multiple of kv heads")
    _require(flash_decode_supported(q.shape[2], q.shape[1] // KV),
             f"no kernel for (head_dim, group) = ({q.shape[2]}, {q.shape[1] // KV}): "
             "the kernels take head dims 64 and 128 and groups of 1 to 4")
    _require(lengths.dtype == torch.int32 and lengths.shape == (B,),
             "lengths must be int32 of shape (B,)")
    _require(lengths.is_contiguous(), "lengths must be contiguous")


def _scratch(q, n_splits):
    # freed when the wrapper returns, before the kernel may have run: safe,
    # since the caching allocator reuses memory in stream order
    B, H, HD = q.shape
    out = torch.empty_like(q)
    m = torch.empty((B * H * n_splits,), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B * H * n_splits * HD,), dtype=torch.float32, device=q.device)
    return out, m, l, acc


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # pointers: q k v [k_scale v_scale | scale] lengths out m l acc; ints; scale; stream
    "mp_decode_attention_layered": [_P] * 10 + [_I] * 9 + [_F, _P],
    "mp_decode_attention_int8_slots": [_P] * 9 + [_I] * 8 + [_F, _P],
}


def _entry(src: str, name: str):
    lib = build.load(src)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _raise_on(lib, status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed: {lib.mp_error_string(status).decode()}")


def decode_attention_layered(
    q: torch.Tensor,        # (B, H, HD) bf16
    k_cache: torch.Tensor,  # (L, B, KV, S, HD) bf16 or int8
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32 live positions
    layer: int,
    *,
    k_scale: Optional[torch.Tensor] = None,  # (L, B, KV, S) fp32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash decode over one layer of the stacked head-major cache."""
    if _on_cpu(q, k_cache, v_cache, lengths, k_scale, v_scale):
        return decode_attention_layered_plain(q, k_cache, v_cache, lengths, layer,
                                              k_scale, v_scale)
    L, B, KV, S, HD = k_cache.shape
    quant = k_scale is not None
    _check_common(q, lengths, B, KV)
    _require(q.shape[2] == HD, "q head_dim differs from the cache's")
    _require(v_cache.shape == k_cache.shape, "k and v caches differ in shape")
    _require(k_cache.dtype == v_cache.dtype == (torch.int8 if quant else torch.bfloat16),
             "cache must be bf16, or int8 with k_scale and v_scale")
    _require(k_cache.is_contiguous() and v_cache.is_contiguous(), "cache must be contiguous")
    if quant:
        _require(v_scale is not None, "int8 cache needs both k_scale and v_scale")
        for sc in (k_scale, v_scale):
            _require(sc.dtype == torch.float32 and sc.shape == (L, B, KV, S)
                     and sc.is_contiguous(), "scales must be contiguous fp32 (L, B, KV, S)")
    _require(0 <= int(layer) < L, f"layer {layer} out of range [0, {L})")
    n_splits = -(-S // SPLIT_LEN)
    out, m, l, acc = _scratch(q, n_splits)
    lib, fn = _entry("decode_attention_layered.cu", "mp_decode_attention_layered")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        status = fn(
            _ptr(q), _ptr(k_cache[layer]), _ptr(v_cache[layer]),
            _ptr(k_scale[layer] if quant else None),
            _ptr(v_scale[layer] if quant else None),
            _ptr(lengths), _ptr(out), _ptr(m), _ptr(l), _ptr(acc),
            B, S, KV, q.shape[1],
            HD, int(quant), n_splits, SPLIT_LEN, SPLIT_BLOCKS_PER_SM, HD**-0.5, stream,
        )
    _raise_on(lib, status, "decode_attention_layered")
    LAUNCHES["decode_attention_layered"] += 1
    return out


def decode_attention(
    q: torch.Tensor,        # (B, H, HD)
    k_cache: torch.Tensor,  # (B, KV, S, HD)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Single-layer flash decode: the layered kernel with L = 1."""
    return decode_attention_layered(q, k_cache[None], v_cache[None], lengths, 0)


def decode_attention_int8_slots(
    q: torch.Tensor,         # (B, H, HD) bf16
    k_cache: torch.Tensor,   # (L, B, S, KV*HD) int8, position-major
    v_cache: torch.Tensor,
    kv_scale: torch.Tensor,  # (L, B, S, 2*KV) fp32: k scales [:KV], v [KV:]
    lengths: torch.Tensor,   # (B,) int32 live positions
    layer: int,
) -> torch.Tensor:
    """Slot-wise flash decode over the int8 position-major cache.

    The kernel reads the ``(L, B, S, 2KV)`` scales in place: the Pallas
    kernel's scale-major copy and its aliasing of the cache through the
    call were Mosaic/XLA workarounds with no counterpart here.
    """
    if _on_cpu(q, k_cache, v_cache, kv_scale, lengths):
        return decode_attention_int8_slots_plain(q, k_cache, v_cache, kv_scale,
                                                 lengths, layer)
    L, B, S, DKV = k_cache.shape
    HD = q.shape[-1]
    _require(DKV % HD == 0, "cache row is not a whole number of heads")
    KV = DKV // HD
    _check_common(q, lengths, B, KV)
    _require(k_cache.dtype == v_cache.dtype == torch.int8, "cache must be int8")
    _require(v_cache.shape == k_cache.shape, "k and v caches differ in shape")
    _require(k_cache.is_contiguous() and v_cache.is_contiguous(), "cache must be contiguous")
    _require(kv_scale.dtype == torch.float32 and kv_scale.shape == (L, B, S, 2 * KV)
             and kv_scale.is_contiguous(), "kv_scale must be contiguous fp32 (L, B, S, 2KV)")
    _require(0 <= int(layer) < L, f"layer {layer} out of range [0, {L})")
    n_splits = -(-S // SPLIT_LEN)
    out, m, l, acc = _scratch(q, n_splits)
    lib, fn = _entry("decode_attention_int8_slots.cu", "mp_decode_attention_int8_slots")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        status = fn(
            _ptr(q), _ptr(k_cache[layer]), _ptr(v_cache[layer]), _ptr(kv_scale[layer]),
            _ptr(lengths), _ptr(out), _ptr(m), _ptr(l), _ptr(acc),
            B, S, KV, q.shape[1],
            HD, n_splits, SPLIT_LEN, SPLIT_BLOCKS_PER_SM, HD**-0.5, stream,
        )
    _raise_on(lib, status, "decode_attention_int8_slots")
    LAUNCHES["decode_attention_int8_slots"] += 1
    return out
