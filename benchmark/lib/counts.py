"""The card's peaks, and the operations and bytes that a run's work
needs, from the counts of the decoder family that ran it.

Peaks are the NVIDIA H100 SXM data sheet's dense rates (as
``chip_smoke.py``'s ``H100_*`` constants): bf16 989 TFLOP/s, int8
1,979 TOP/s, HBM3 3.35 TB/s.  The counts depend on the decoder's block,
so each family keeps them in ``families/<family>/counts.py``; each
function here takes ``d`` (``run.d``, which names its family) and calls
the family's function of the same name, and a family without it raises
instead of reading another block's numbers.
"""
from __future__ import annotations

from typing import Dict

BF16_FLOPS = 989e12
INT8_OPS = 1.979e15
HBM_BYTES = 3.35e12


def _family(d: Dict):
    from . import spec

    return spec.family_counts(d["family"])


def head_gemv_bytes(d: Dict, rows: int) -> int:
    return _family(d).head_gemv_bytes(d, rows)


def decode_step_gemv_bytes(d: Dict, rows: int) -> int:
    return _family(d).decode_step_gemv_bytes(d, rows)


def w8a8_round_bound_s(d: Dict, rows: int) -> float:
    return _family(d).w8a8_round_bound_s(d, rows)


def decode_token_s_at_peak(d: Dict, keys: int) -> float:
    return _family(d).decode_token_s_at_peak(d, keys)


def prefill_tokens_s_at_peak(d: Dict, offset: int, n: int) -> float:
    return _family(d).prefill_tokens_s_at_peak(d, offset, n)
