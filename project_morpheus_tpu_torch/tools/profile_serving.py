"""Where a serving run's time goes on the card.

    python -m project_morpheus_tpu_torch.tools.profile_serving

Builds the serving runtime of ``SERVING_ENV`` (Orpheus-3B, int8 weights,
int8 KV cache, 8 slots x 8192, banded sampling, the slot kernel), runs ``warm`` (the
engine's ``warmup`` for this workload: every frame program and prefill
round captured as a CUDA graph), serves one short warm-up request, then serves ``PROMPTS``
(one ~2,500-token prompt and three short ones), ``TOKENS_PER_REQUEST``
tokens each:

1. unprofiled: wall time, ms per decode step, each request's time to
   first audio (TTFA), and host time per engine phase from the engine's
   trace spans (``engine.dispatch``: staging the gate and a graph replay;
   ``engine.prefill_round``; ``engine.route``), and each prefill round's
   host and device time (``round_timer``; a round is a graph replay too);
   then a burst of four ``BURST_PROMPT`` requests
   (J-batched prefill rounds) and their TTFA;
2. under ``torch.profiler`` tracing the card only (``device_trace``): the
   device's busy share of the window (the union of its kernels' spans), and
   device time by kernel name, in
   total and per frame (a frame is ``steps_per_sync`` decode steps; the
   tracer adds some host time of its own), and the w8a8 GEMM's and
   quantize's (``ops/w8a8_gemm.py``) device time in the window;
3. the same for the three short prompts alone, a window of mostly frame
   programs: what one frame costs on the device;
4. the same for the long prompt alone and one frame: mostly its three
   prefill rounds.

The warmup line gives the bytes of the CUDA graphs' memory pool.  Then
prints the card's name and power limit.  ``chip_smoke.py`` serves
the same workload through ``serving_runtime``, ``warm`` and these
constants.

It needs a CUDA card and fails without one.
"""
from __future__ import annotations

import asyncio
import contextlib
import os
import subprocess
import time

SERVING_ENV = dict(ORPHEUS_MODEL_SIZE="3b", ORPHEUS_QUANT="int8", ORPHEUS_KV_QUANT="int8",
                   ORPHEUS_MAX_SEQ="8192", ORPHEUS_MAX_SLOTS="8")
# three prefill chunks, and a decode context bucket >= 2048 (the slot kernel)
LONG_PROMPT = ("The quick brown fox jumps over the lazy dog near the river bank. " * 40)[:2480]
PROMPTS = (LONG_PROMPT, "Hello there, how are you today?", "A short sentence.",
           "Streaming speech from the card.")
TOKENS_PER_REQUEST = 7 * 24  # 24 codec frames
# ~1,300 tokens: two prefill chunks (1024, then 512), for burst admissions
BURST_PROMPT = LONG_PROMPT[:1300]
TOP_KERNELS = 30


def serving_runtime(**kw):
    """Build the ``SERVING_ENV`` runtime on the card (``kw`` goes to
    ``ServingRuntime``) and make it the process's runtime.

    Decode attention defaults to the slot kernel at every context bucket:
    it reads each slot's live length, so a seeded request's trace does not
    depend on the bucket its co-batched traffic sets (under the server's
    ``"auto"``, a bucket below ``pallas_min_bucket`` switches to the dense
    int8 branch, whose numbers differ in the last bits, as in the JAX
    engine).  Pass ``attn_impl="auto"`` to serve as the server does."""
    from ..adapters import runtime as rt

    os.environ.update(SERVING_ENV)
    kw.setdefault("attn_impl", "kernel")
    runtime = rt.ServingRuntime(device="cuda", banded_sampling=True, **kw)
    runtime.build()
    rt.set_runtime(runtime)
    return runtime


def warm(engine, prompts=(*PROMPTS, BURST_PROMPT), burst: int = 4):
    """``engine.warmup`` for ``prompts`` (by default ``PROMPTS`` and bursts
    of four ``BURST_PROMPT``): returns (programs exercised, seconds)."""
    import torch

    from ..model.tokenizer import format_prompt_ids

    lens = [len(format_prompt_ids(p, "tara")) for p in prompts]
    t0 = time.perf_counter()
    n = engine.warmup(lens, TOKENS_PER_REQUEST, burst=burst)
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def busy_seconds(spans) -> float:
    """Length of the union of ``(start_ns, end_ns)`` spans, in seconds:
    kernels that overlap (a programmatic dependent launch beside the one
    it follows) count once."""
    total, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e9


@contextlib.contextmanager
def device_trace():
    """Trace the card's activity with ``torch.profiler`` over the block; the
    yielded dict is filled on exit with ``ops``, {name: [device us, count]}
    of the card's kernels and copies, and ``busy_s``, the time the card ran
    any of them (the union of their spans), both from the raw Kineto events
    (no function-event tree: a serving run traces ~400,000 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trace: dict = {"ops": {}, "busy_s": 0.0}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield trace
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            rec = trace["ops"].setdefault(e.name(), [0.0, 0])
            rec[0] += e.duration_ns() / 1e3
            rec[1] += 1
            spans.append((e.start_ns(), e.end_ns()))
    trace["busy_s"] = busy_seconds(spans)


@contextlib.contextmanager
def engine_spans(engine):
    """The engine's trace (``engine/trace.py``) over the block: turned on
    for it if it was off (and off again after); the yielded list is filled
    on exit with the spans recorded inside the block."""
    was_on = engine.trace is not None
    trace = engine.start_trace()
    first = len(trace.spans)
    spans: list = []
    try:
        yield spans
    finally:
        spans.extend(trace.spans[first:])
        if not was_on:
            engine.stop_trace()


@contextlib.contextmanager
def round_timer(engine):
    """Time each prefill round ``engine`` runs inside the block, from its
    ``engine.prefill_round`` spans: the yielded dict is filled on exit with
    ``rounds``, ``host_s`` (the host's time in the round: staging the
    inputs, a graph replay or the eager launches, the first tokens' copy)
    and ``device_s`` (the span's CUDA events on the stream before and after
    the round: its device time, copies included, once the work ahead of it
    has run; 0 off the card)."""
    from ..engine.trace import device_seconds

    stats = {"rounds": 0, "host_s": 0.0, "device_s": 0.0}
    with engine_spans(engine) as spans:
        yield stats
    rounds = [s for s in spans if s.name == "engine.prefill_round"]
    stats["rounds"] = len(rounds)
    stats["host_s"] = sum(s.end_ns - s.start_ns for s in rounds) / 1e9
    stats["device_s"] = device_seconds(rounds)


def host_totals(spans, names) -> dict:
    """{name: [host seconds, spans]} of the spans of each of ``names``."""
    totals = {name: [0.0, 0] for name in names}
    for s in spans:
        if s.name in totals:
            totals[s.name][0] += (s.end_ns - s.start_ns) / 1e9
            totals[s.name][1] += 1
    return totals


async def _serve(prompts, max_tokens):
    """Serve ``prompts`` at once: [(PCM bytes, seconds to the first PCM)]."""
    from ..adapters.local_torch import LocalTorchAdapter
    from ..model.sampling import SamplingParams

    async def pull(a):
        n, t0, ttfa = 0, time.perf_counter(), None
        while True:
            c = await a.pull(4096)
            if c.pcm and ttfa is None:
                ttfa = time.perf_counter() - t0
            n += len(c.pcm)
            if c.eos:
                return n, ttfa

    sp = SamplingParams(max_tokens=max_tokens)
    return await asyncio.gather(*[pull(LocalTorchAdapter(p, sampling=sp)) for p in prompts])


def _ttfa(served) -> str:
    return ", ".join("none" if t is None else f"{t:.3f}" for _, t in served)


async def _profiled(eng, prompts, what: str, max_tokens: int = TOKENS_PER_REQUEST) -> None:
    """Serve ``prompts`` under ``device_trace``: busy share of the window,
    and the top device operations in total and per frame."""
    import torch

    steps0 = eng.steps
    t_all = time.perf_counter()
    with device_trace() as dev:
        t0 = time.perf_counter()
        await _serve(prompts, max_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    frames = max(1, (eng.steps - steps0) // eng.steps_per_sync)
    rows = sorted(((us, n, name) for name, (us, n) in dev["ops"].items()), reverse=True)
    busy, summed = dev["busy_s"], sum(r[0] for r in rows) / 1e6
    ops = sum(r[1] for r in rows)
    print(f"profiled, {what}: {wall:.3f} s wall, {frames} frames, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%; summed op time {summed:.3f} s), "
          f"{busy / frames * 1e3:.2f} ms of device time a frame, "
          f"{ops} device operations ({ops / frames:.0f} a frame; profiler start and trace "
          f"read: {time.perf_counter() - t_all - wall:.1f} s)")
    for dev_us, count, key in rows[:TOP_KERNELS]:
        print(f"  {dev_us / 1e3:10.2f} ms {100 * dev_us / 1e6 / summed:5.1f}% "
              f"{dev_us / frames / 1e3:7.3f} ms/frame {count:7d}x  {key[:100]}")
    for kernel in ("w8a8_gemm", "w8a8_quantize"):
        us = sum(r[0] for r in rows if kernel in r[2])
        print(f"  {kernel}: {us / 1e3:.2f} ms in {sum(r[1] for r in rows if kernel in r[2])} calls "
              f"({100 * us / 1e6 / busy:.1f}% of the busy time)")


async def _main() -> None:
    import torch

    eng = serving_runtime().engine
    n, secs = warm(eng)
    print(f"warmup: {n} programs in {secs:.2f} s, {eng.programs.captures} CUDA graphs, graph "
          f"pool {eng.programs.pool_bytes() / 2**30:.3f} GiB")
    await _serve(["Warm up."], 14)
    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with engine_spans(eng) as spans, round_timer(eng) as rounds:
        pcm = await _serve(PROMPTS, TOKENS_PER_REQUEST)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = host_totals(spans, ("engine.dispatch", "engine.prefill_round", "engine.route"))
    steps = eng.steps - steps0
    print(f"unprofiled: {wall:.3f} s wall, {steps} decode steps, {sum(b for b, _ in pcm)} PCM "
          f"bytes, {wall / max(steps, 1) * 1e3:.2f} ms per step over the window; TTFA s "
          f"{_ttfa(pcm)}")
    for name, (secs, n) in totals.items():
        print(f"  host {name}: {secs:.3f} s in {n} calls ({secs / max(n, 1) * 1e3:.2f} ms/call)")
    n = max(rounds["rounds"], 1)
    print(f"  prefill rounds: {rounds['rounds']}, host {rounds['host_s'] / n * 1e3:.2f} ms a "
          f"round, device {rounds['device_s'] / n * 1e3:.2f} ms a round")
    with round_timer(eng) as rounds:
        burst = await _serve([BURST_PROMPT] * 4, 7 * 12)
    n = max(rounds["rounds"], 1)
    print(f"burst of 4: TTFA s {_ttfa(burst)}; prefill rounds {rounds['rounds']}, device "
          f"{rounds['device_s'] / n * 1e3:.2f} ms a round")

    await _profiled(eng, PROMPTS, "the whole load")
    # the short prompts alone: their prefill is a few small chunks, so the
    # window is mostly frame programs (graph replays)
    await _profiled(eng, PROMPTS[1:], "short prompts only")
    # the long prompt alone for one frame: mostly its three prefill rounds
    await _profiled(eng, PROMPTS[:1], "the long prompt, one frame", max_tokens=7)
    await eng.close()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    asyncio.run(_main())


if __name__ == "__main__":
    main()
