"""Device timestamps inside a program (CUDA, ``csrc/stamp.cu``).

``stamp(buf, i, code)`` writes ``(code, time in ns)`` to row ``i`` of an
int64 ``(n, 2)`` buffer, in stream order: on the card a one-thread kernel
that reads the card's global timer once the work before it has run, so
it can be captured into a CUDA graph and is taken again at every replay;
on the CPU the host clock (``time.perf_counter_ns``), which is the time
the eager work before it ended.

Not a port of a Pallas kernel: the engine's trace (``engine/trace.py``)
splits a frame program's device time by stage with it.  The kernel lets
a programmatic dependent launch after it (the int8 GEMV) start at once.
``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import time

import torch

from . import build

SOURCE = "stamp.cu"

LAUNCHES = {"stamp": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry():
    lib = build.load(SOURCE)
    fn = lib.mp_stamp
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def stamp(buf: torch.Tensor, i: int, code: int) -> None:
    """Write ``(code, now)`` to ``buf[i]`` once the work before it on the
    stream has run."""
    if buf.dtype != torch.int64 or buf.ndim != 2 or buf.shape[1] != 2 or not buf.is_contiguous():
        raise ValueError("stamp takes a contiguous int64 (n, 2) buffer")
    if not 0 <= i < buf.shape[0]:
        raise IndexError(f"stamp row {i} outside a buffer of {buf.shape[0]} rows")
    if buf.device.type == "cpu":
        buf[i, 0] = code
        buf[i, 1] = time.perf_counter_ns()
        return
    if buf.device.type != "cuda":
        raise ValueError(f"stamp takes a cpu or cuda buffer, got {buf.device}")
    lib, fn = _entry()
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device):
        status = fn(buf.data_ptr() + 16 * i, code, stream)
    if status != 0:
        raise RuntimeError(f"stamp launch failed: {lib.mp_error_string(status).decode()}")
    LAUNCHES["stamp"] += 1
