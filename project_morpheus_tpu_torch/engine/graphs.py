"""The engine's program cache: frame programs and prefill rounds as
captured CUDA graphs.

The counterpart of the JAX engine's ``jax.jit`` with ``static_argnames``: a
program is a function of no arguments that reads and writes only tensors
that outlive it (the slot table, the KV cache, the codec state, a static
gate buffer, a prefill round's input buffers), keyed as JAX keys its
programs: a frame program by ``(bucket, attn_impl, n_steps, n_frames,
audio, banded, lenient)``, a prefill round by ``("prefill", chunk_len,
hist_bucket, final, J, banded, lenient, w8a8)``.

- On the card, the first call with a key runs the function once eagerly on
  a side stream (its real work, and its outputs, are this call's) and then
  captures it with ``torch.cuda.graph``; later calls ``replay()`` the graph
  and return its static outputs, which the next replay of the same key
  overwrites.  All graphs share one memory pool.
- On the CPU, or with graphs turned off, the function runs eagerly.

Every key run is recorded in ``keys`` either way, so tests on the CPU can
check which programs serving reaches; ``replayed`` counts the replays of
each key.

Launch counts: the kernel wrappers of ``ops/`` count in Python, so they
tick while a graph is captured (when nothing is launched) and not when it
is replayed.  The cache therefore takes each graph's per-kernel tally at
capture, takes it back out of the counters, and adds it on every replay.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple

import torch

from ..ops import decode_trunk, int8_gemv, prefill_attention, stamp, w8a8_gemm
from ..ops.decode_attention import LAUNCHES as _DECODE_ATTENTION_LAUNCHES

_COUNTERS = (_DECODE_ATTENTION_LAUNCHES, int8_gemv.LAUNCHES, prefill_attention.LAUNCHES,
             w8a8_gemm.LAUNCHES, decode_trunk.LAUNCHES, stamp.LAUNCHES)


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


def _tally_since(before: List[Dict[str, int]]) -> List[Dict[str, int]]:
    """Counts added since ``before``; the counters go back to ``before``."""
    tally = []
    for counter, was in zip(_COUNTERS, before):
        tally.append({k: counter[k] - was[k] for k in counter})
        counter.update(was)
    return tally


def _add(tally: List[Dict[str, int]]) -> None:
    for counter, t in zip(_COUNTERS, tally):
        for k, n in t.items():
            counter[k] += n


class ProgramCache:
    """Programs by key: captured CUDA graphs on the card, eager elsewhere."""

    def __init__(self, device: torch.device, graphs: bool = True) -> None:
        self.device = device
        self.graphs = graphs and device.type == "cuda"
        self.keys: set = set()
        self._graphs: Dict[tuple, Tuple[torch.cuda.CUDAGraph, tuple, list]] = {}
        self._pool = None
        self.captures = 0
        self.replayed: collections.Counter = collections.Counter()

    @property
    def replays(self) -> int:
        return sum(self.replayed.values())

    @property
    def graph_keys(self) -> set:
        """Keys captured as graphs."""
        return set(self._graphs)

    def pool_bytes(self) -> int:
        """Bytes of device memory the graphs' shared pool holds."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def run(self, key: tuple, fn: Callable[[], tuple], graph: bool = True) -> tuple:
        """Run program ``key``; ``fn`` returns a tuple of output tensors.
        ``graph=False`` runs it eagerly, as without graphs."""
        self.keys.add(key)
        if not (self.graphs and graph):
            return fn()
        entry = self._graphs.get(key)
        if entry is not None:
            graph, outs, tally = entry
            graph.replay()
            _add(tally)
            self.replayed[key] += 1
            return outs
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = fn()
        cur.wait_stream(side)
        for t in outs:
            t.record_stream(cur)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        # thread-local: the readback workers may wait on events meanwhile
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            static = fn()
        self._graphs[key] = (graph, static, _tally_since(before))
        self.captures += 1
        return outs


class StaticInputs:
    """A program's input buffers on the device, written from host arrays
    on the stream before each run.

    On the card each buffer has two pinned host copies, used in turn: a
    copy is written again only once the device has read it (an event a
    turn), so staging allocates nothing and waits at most for the copy two
    turns back.  Elsewhere the buffers are written directly."""

    def __init__(self, specs, device: torch.device) -> None:
        self.bufs = [torch.zeros(shape, dtype=dt, device=device) for shape, dt in specs]
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._host = [[torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt in specs]
                          for _ in range(2)]
            self._read: List = [None, None]
            self._turn = 0

    def stage(self, arrays) -> None:
        if not self._cuda:
            for buf, arr in zip(self.bufs, arrays):
                buf.copy_(torch.from_numpy(arr))
            return
        turn, self._turn = self._turn, self._turn ^ 1
        if self._read[turn] is not None:
            self._read[turn].synchronize()
        for host, buf, arr in zip(self._host[turn], self.bufs, arrays):
            host.numpy()[...] = arr
            buf.copy_(host, non_blocking=True)
        self._read[turn] = torch.cuda.Event()
        self._read[turn].record()

