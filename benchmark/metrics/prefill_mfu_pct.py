"""Model FLOPs of the window's prefilled prompt tokens, each term at its
configured precision's peak (the w8a8 projections at int8 1,979 TOP/s,
causal attention and the last-position head at bf16 989 TFLOP/s), over
the prefill rounds' device time (CUDA events)."""
from benchmark.lib import counts


def read(run):
    t = run.tracer
    rs = [r for r in (t.rounds if t else []) if r.get("device_s") is not None]
    if not rs:
        return None
    at_peak = sum(counts.prefill_tokens_s_at_peak(run.d, off, n) for r in rs
                  for off, n in r["jobs"])
    return 100.0 * at_peak / sum(r["device_s"] for r in rs)
