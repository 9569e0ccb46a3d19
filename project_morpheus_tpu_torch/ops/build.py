"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library of its own with a plain C interface, loaded with
``ctypes``.  Nothing includes PyTorch's headers, so a build takes seconds.
Libraries land in ``ops/_build/`` (listed in ``.gitignore``), named by a
hash of the sources, so a changed source rebuilds and an unchanged one is
reused.  All sources build in parallel, one ``nvcc`` each.

Nothing here runs at import time: the first kernel launch builds, or a
caller (``chip_smoke.py``) calls :func:`build_all` up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("decode_attention_layered.cu", "decode_attention_int8_slots.cu", "int8_gemv.cu",
           "prefill_chunk_attention.cu", "w8a8_gemm.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source's last build
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source not built yet, all at once; returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        todo = [s for s in SOURCES if s not in _libs and not _lib_path(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs: List[tuple] = []
            for src in todo:
                out = _lib_path(src)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                build_logs[src] = log
                if proc.returncode != 0:
                    failed.append(f"{src}:\n{log}")
                else:
                    os.replace(tmp, out)  # atomic: a concurrent builder sees whole files
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _libs.get(src)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(src)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(src)))
                lib.mp_error_string.restype = ctypes.c_char_p
                lib.mp_error_string.argtypes = [ctypes.c_int]
                _libs[src] = lib
    return lib
