"""Device ms a prefill round (CUDA events around each
``OrpheusEngine._prefill_round``), mean over the window's rounds."""


def read(run):
    t = run.tracer
    rs = [r for r in (t.rounds if t else []) if r.get("device_s") is not None]
    if not rs:
        return None
    return sum(r["device_s"] for r in rs) / len(rs) * 1e3
