"""Model FLOPs of the window's decoded tokens (2 x matmul params, head
included, and 4 x keys x H x HD a layer, for each token at the keys its
step attended) at the bf16 peak, 989 TFLOP/s, over the frame programs'
device time (CUDA events)."""
from benchmark.lib import counts


def read(run):
    t = run.tracer
    fr = [f for f in (t.frames if t else []) if f.get("device_s") is not None]
    if not fr or not t.tokens:
        return None
    at_peak = sum(counts.decode_token_s_at_peak(run.d, k) for f in t.tokens for k in f["keys"])
    return 100.0 * at_peak / sum(f["device_s"] for f in fr)
