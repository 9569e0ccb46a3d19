"""Host ms a frame dispatch (``OrpheusEngine._dispatch_frame``: a graph
replay and its readback copies), mean over the window's dispatches."""


def read(run):
    t = run.tracer
    if t is None or not t.dispatch_host_s:
        return None
    return sum(t.dispatch_host_s) / len(t.dispatch_host_s) * 1e3
