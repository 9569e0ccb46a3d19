"""Device ms a frame program takes per frame (7 decode steps and a SNAC
hop), from CUDA events around each run, mean over the window."""
from benchmark.lib.readers import device_ms_per_frame


def read(run):
    return device_ms_per_frame(run)
