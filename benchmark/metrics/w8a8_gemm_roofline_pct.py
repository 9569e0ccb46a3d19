"""The w8a8 GEMM's share of its roofline in the traced slice: for each
round, the larger of its projections' operations (2 x J x chunk x K x N)
over 1,979 TOP/s and their bytes over 3.35 TB/s, summed over the slice's
rounds, over the device time of the ``w8a8_gemm`` kernels in the trace."""
import re

from benchmark.lib import counts

KERNEL = re.compile(r"\bw8a8_gemm\b")


def read(run):
    t = run.tracer
    ops = (t.trace.get("ops") if t else None) or {}
    secs = sum(v[0] for name, v in ops.items() if KERNEL.search(name))
    rounds = [r for r in t.rounds if r["slice"]] if t else []
    if secs <= 0 or not rounds:
        return None
    bound = sum(counts.w8a8_round_bound_s(run.d, r["J"] * r["clen"]) for r in rounds)
    return 100.0 * bound / secs
