"""The llama family's operations and bytes: what a decode step, a
prefill round and a token need, from the block's widths (``run.d``) and
the engine's counts, against the card's peaks (``lib/counts.py``).

None of it depends on which kernel computes the work: a later kernel that
does the same work is measured against the same counts.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.lib.counts import BF16_FLOPS, HBM_BYTES, INT8_OPS


def layer_mats(d: Dict) -> List[Tuple[int, int]]:
    """(K, N) of one layer's projections as served: qkv, o, gate|up, down."""
    D, F, H, KV, HD = d["D"], d["F"], d["H"], d["KV"], d["HD"]
    return [(D, (H + 2 * KV) * HD), (H * HD, D), (D, 2 * F), (F, D)]


def matmul_params(d: Dict) -> int:
    """Weights a token multiplies: every layer's projections and the head."""
    return d["L"] * sum(k * n for k, n in layer_mats(d)) + d["D"] * d["Vp"]


def head_gemv_bytes(d: Dict, rows: int) -> int:
    """The int8 head's call on ``rows`` rows: int8 weight, fp32 column (or
    row) scales, bf16 rows in, logits out (fp32 from a tied head's K-major
    call, bf16 from an untied head's)."""
    out = 4 if d["tied"] else 2
    return d["D"] * d["Vp"] + 4 * d["Vp"] + rows * (2 * d["D"] + out * d["Vp"])


def decode_step_gemv_bytes(d: Dict, rows: int) -> int:
    """The bytes a decode step's int8 GEMV calls need: every layer weight
    and its scales read once, bf16 rows in and out, then the head."""
    per_layer = sum(k * n + 4 * n + rows * 2 * (k + n) for k, n in layer_mats(d))
    return d["L"] * per_layer + head_gemv_bytes(d, rows)


def w8a8_round_bound_s(d: Dict, rows: int) -> float:
    """Least time of one round's w8a8 GEMMs on ``rows`` padded rows: for
    each projection the larger of 2 * rows * K * N / int8 peak and its
    bytes (int8 weight and rows, fp32 scales, bf16 out) / HBM."""
    t = 0.0
    for k, n in layer_mats(d):
        ops = 2 * rows * k * n
        nbytes = k * n + 4 * n + rows * (k + 4 + 2 * n)
        t += max(ops / INT8_OPS, nbytes / HBM_BYTES)
    return d["L"] * t


def attn_flops(d: Dict, keys: int) -> int:
    """One query's attention over ``keys`` positions, all layers: q.k and
    p.v, 2 * keys * HD each, for every head."""
    return 4 * keys * d["H"] * d["HD"] * d["L"]


def decode_token_s_at_peak(d: Dict, keys: int) -> float:
    """One decoded token's model FLOPs at the bf16 peak (int8 weights are
    dequantized into bf16 products): 2 * matmul params + attention."""
    return (2 * matmul_params(d) + attn_flops(d, keys)) / BF16_FLOPS


def prefill_tokens_s_at_peak(d: Dict, offset: int, n: int) -> float:
    """A job's ``n`` prompt tokens from position ``offset``, each term at
    its precision's peak: the projections at int8 (w8a8), causal attention
    at bf16, and the head's one last-position row at bf16."""
    if n <= 0:
        return 0.0
    proj = 2 * n * d["L"] * sum(k * m for k, m in layer_mats(d))
    keys = n * offset + n * (n + 1) // 2  # position p attends p + 1 keys
    head = 2 * d["D"] * d["Vp"]
    return proj / INT8_OPS + (attn_flops(d, 1) * keys + head) / BF16_FLOPS
