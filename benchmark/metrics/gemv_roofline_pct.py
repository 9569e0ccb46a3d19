"""The int8 GEMV's share of its roofline in the traced slice: the bytes
the slice's decode steps and prefill heads need (``lib/counts.py``: every
int8 weight and scale read once a step, bf16 rows in and out), over
3.35 TB/s, over the device time of the GEMV kernels (``gemv_kn``,
``gemv_nk``) in the trace."""
import re

from benchmark.lib import counts

KERNEL = re.compile(r"\bgemv_(kn|nk)\b")


def read(run):
    t = run.tracer
    ops = (t.trace.get("ops") if t else None) or {}
    secs = sum(v[0] for name, v in ops.items() if KERNEL.search(name))
    if secs <= 0:
        return None
    steps = sum(f["k"] for f in t.frames if f["slice"]) * run.steps_per_sync
    nbytes = steps * counts.decode_step_gemv_bytes(run.d, run.slots)
    nbytes += sum(counts.head_gemv_bytes(run.d, r["J"]) for r in t.rounds if r["slice"])
    return 100.0 * nbytes / counts.HBM_BYTES / secs
