"""Arithmetic that more than one metric reader shares."""


def device_ms_per_frame(run):
    """Device ms a frame (CUDA events around each ``_run_program``), over
    every frame program the window ran."""
    t = run.tracer
    fr = [f for f in (t.frames if t else []) if f.get("device_s") is not None]
    if not fr:
        return None
    return sum(f["device_s"] for f in fr) / sum(f["k"] for f in fr) * 1e3


def idle_pct(run):
    """100 x (1 - device busy / traced slice), the busy time the union of
    the slice's kernel and copy spans."""
    t = run.tracer
    tr = t.trace if t else {}
    if not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
