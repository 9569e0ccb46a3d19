"""The engine's program cache: frame programs as captured CUDA graphs.

The counterpart of the JAX engine's ``jax.jit`` with ``static_argnames``: a
program is a function of no arguments that reads and writes only tensors
that outlive it (the slot table, the KV cache, the codec state, a static
gate buffer), keyed as JAX keys its frame programs:
``(bucket, attn_impl, n_steps, n_frames, audio, banded, lenient)``.

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

from ..ops import decode_attention, int8_gemv

_COUNTERS = (decode_attention.LAUNCHES, int8_gemv.LAUNCHES)


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

    def run(self, key: tuple, fn: Callable[[], tuple]) -> tuple:
        """Run program ``key``; ``fn`` returns a tuple of output tensors."""
        self.keys.add(key)
        if not self.graphs:
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
