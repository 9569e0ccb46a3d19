"""Native (C++) PCM library: build at first use, ctypes bindings (port of
native/__init__.py).

``pcm_ops.cpp`` compiles with ``g++`` into ``native/_build/`` (listed in
``.gitignore``), named by a hash of the source and flags, so a changed
source rebuilds and an unchanged one is reused; the build writes a
temporary file and renames it, so concurrent first uses never load a torn
library.

Delegation is flag-gated, as in the JAX package: with
``ORPHEUS_NATIVE_PCM=1`` the orchestrator's ``RingBuffer`` and
``crossfade`` run on this library; unset, nothing is built and the Python
twins in ``orchestrator/`` run (they are also the oracle of
``tests/test_torch_native.py``).  One deliberate divergence: with the flag
set, a build or load failure raises, where the JAX package's ``enabled()``
quietly returns False and serves on the Python path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "pcm_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
FLAG = "ORPHEUS_NATIVE_PCM"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I16P = ctypes.POINTER(ctypes.c_int16)
_SIGNATURES = {
    "pcm_ring_create": (ctypes.c_void_p, [ctypes.c_size_t]),
    "pcm_ring_destroy": (None, [ctypes.c_void_p]),
    "pcm_ring_size": (ctypes.c_size_t, [ctypes.c_void_p]),
    "pcm_ring_free": (ctypes.c_size_t, [ctypes.c_void_p]),
    "pcm_ring_write": (ctypes.c_size_t, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]),
    "pcm_ring_read": (ctypes.c_size_t,
                      [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]),
    "pcm_ring_reset": (None, [ctypes.c_void_p]),
    "pcm_crossfade_join": (ctypes.c_size_t,
                           [_I16P, ctypes.c_size_t, _I16P, ctypes.c_size_t, ctypes.c_size_t,
                            _I16P]),
    "pcm_f32_to_i16": (None, [ctypes.POINTER(ctypes.c_float), ctypes.c_size_t, _I16P]),
    "pcm_i16_to_f32": (None, [_I16P, ctypes.c_size_t, ctypes.POINTER(ctypes.c_float)]),
    "pcm_meter": (ctypes.c_double, [_I16P, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double)]),
}


def lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpcm_ops-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native pcm_ops: g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native pcm_ops: g++ failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The bound library, built on first use; raises if it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (builds it if needed)."""
    try:
        load()
        return True
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False


def enabled() -> bool:
    """``ORPHEUS_NATIVE_PCM`` is 1/true/on: the ring and crossfade delegate
    to the library, which is then built and loaded here (a failure
    raises).  Unset: False, and nothing is built."""
    if os.environ.get(FLAG, "").lower() not in ("1", "true", "on"):
        return False
    load()
    return True


class NativeRing:
    """ctypes wrapper over the C++ PCM byte ring (the core ops of
    ``orchestrator.RingBuffer``)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._h = self._lib.pcm_ring_create(capacity)
        self.capacity = capacity

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pcm_ring_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return self._lib.pcm_ring_size(self._h)

    @property
    def free(self) -> int:
        return self._lib.pcm_ring_free(self._h)

    def write(self, data: bytes) -> int:
        return self._lib.pcm_ring_write(self._h, bytes(data), len(data))

    def read(self, size: int) -> bytes:
        buf = (ctypes.c_uint8 * max(size, 0))()
        n = self._lib.pcm_ring_read(self._h, buf, max(size, 0))
        return bytes(buf[:n])

    def reset(self) -> None:
        self._lib.pcm_ring_reset(self._h)


def _i16(a: np.ndarray):
    return a.ctypes.data_as(_I16P)


def crossfade_join(tail: np.ndarray, head: np.ndarray, overlap: int) -> np.ndarray:
    """``tail[:-ov] ++ mix ++ head[ov:]`` with linear fades, ``ov`` clamped
    to both sizes (``orchestrator.stitcher.crossfade``)."""
    lib = load()
    tail = np.ascontiguousarray(tail, np.int16)
    head = np.ascontiguousarray(head, np.int16)
    out = np.empty(tail.size + head.size, np.int16)
    n = lib.pcm_crossfade_join(_i16(tail), tail.size, _i16(head), head.size,
                               max(int(overlap), 0), _i16(out))
    return out[:n]


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16: times 32767, clipped, truncated toward zero."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.size, np.int16)
    lib.pcm_f32_to_i16(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size, _i16(out))
    return out


def meter(pcm: np.ndarray) -> Tuple[float, float]:
    """``(rms, peak)`` of int16 PCM, both in [0, 1]."""
    lib = load()
    pcm = np.ascontiguousarray(pcm, np.int16)
    peak = ctypes.c_double()
    rms = lib.pcm_meter(_i16(pcm), pcm.size, ctypes.byref(peak))
    return float(rms), float(peak.value)
