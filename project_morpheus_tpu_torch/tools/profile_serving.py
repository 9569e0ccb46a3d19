"""Where a serving run's time goes on the card.

    python -m project_morpheus_tpu_torch.tools.profile_serving

Builds the serving runtime of ``SERVING_ENV`` (Orpheus-3B, int8 weights,
int8 KV cache, 8 slots x 8192, banded sampling, the slot kernel), runs ``warm`` (the
engine's ``warmup`` for this workload: every frame program and prefill
round captured as a CUDA graph), serves one short warm-up request, then serves ``PROMPTS``
(one ~2,500-token prompt and three short ones), ``TOKENS_PER_REQUEST``
tokens each:

1. unprofiled: wall time, ms per decode step, and host time per engine
   phase (frame dispatch, i.e. a graph replay and its readback copies,
   prefill rounds, routing), and each prefill round's host and device
   time (``round_timer``; a round is a graph replay too);
2. under ``torch.profiler`` tracing the card only (``device_trace``): the
   device's busy share of the window (the union of its kernels' spans), and
   device time by kernel name, in
   total and per frame (a frame is ``steps_per_sync`` decode steps; the
   tracer adds some host time of its own);
3. the same for the three short prompts alone, a window of mostly frame
   programs: what one frame costs on the device;
4. the same for the long prompt alone and one frame: mostly its three
   prefill rounds.

Then prints the card's name and power limit.  ``chip_smoke.py`` serves
the same workload through ``serving_runtime``, ``warm`` and these
constants.

It needs a CUDA card and fails without one.
"""
from __future__ import annotations

import asyncio
import collections
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
def round_timer(engine):
    """Time each prefill round ``engine`` runs inside the block: the yielded
    dict is filled on exit with ``rounds``, ``host_s`` (the host's time in
    ``_prefill_round``: staging the inputs, a graph replay or the eager
    launches, the first tokens' copy) and ``device_s`` (CUDA events on the
    stream before and after each round: its device time, copies included,
    once the work ahead of it has run)."""
    import torch

    fn = engine._prefill_round
    stats = {"rounds": 0, "host_s": 0.0, "device_s": 0.0}
    marks = []

    def timed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        try:
            return fn(*a, **k)
        finally:
            end.record()
            stats["host_s"] += time.perf_counter() - t0
            stats["rounds"] += 1
            marks.append((start, end))

    engine._prefill_round = timed
    try:
        yield stats
    finally:
        del engine._prefill_round  # the class's method again
        torch.cuda.synchronize()
        stats["device_s"] = sum(s.elapsed_time(e) for s, e in marks) / 1e3


def _wrap(engine, name, totals):
    fn = getattr(engine, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            totals[name][0] += time.perf_counter() - t0
            totals[name][1] += 1

    setattr(engine, name, timed)


async def _serve(prompts, max_tokens):
    from ..adapters.local_torch import LocalTorchAdapter
    from ..model.sampling import SamplingParams

    async def pull(a):
        n = 0
        while True:
            c = await a.pull(4096)
            n += len(c.pcm)
            if c.eos:
                return n

    sp = SamplingParams(max_tokens=max_tokens)
    return await asyncio.gather(*[pull(LocalTorchAdapter(p, sampling=sp)) for p in prompts])


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


async def _main() -> None:
    import torch

    eng = serving_runtime().engine
    n, secs = warm(eng)
    print(f"warmup: {n} programs in {secs:.2f} s, {eng.programs.captures} CUDA graphs")
    await _serve(["Warm up."], 14)
    totals = collections.defaultdict(lambda: [0.0, 0])
    for name in ("_dispatch_frame", "_advance_prefill", "_process_frame"):
        _wrap(eng, name, totals)
    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with round_timer(eng) as rounds:
        pcm = await _serve(PROMPTS, TOKENS_PER_REQUEST)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = eng.steps - steps0
    print(f"unprofiled: {wall:.3f} s wall, {steps} decode steps, {sum(pcm)} PCM bytes, "
          f"{wall / max(steps, 1) * 1e3:.2f} ms per step over the window")
    for name, (secs, n) in totals.items():
        print(f"  host {name}: {secs:.3f} s in {n} calls ({secs / max(n, 1) * 1e3:.2f} ms/call)")
    n = max(rounds["rounds"], 1)
    print(f"  prefill rounds: {rounds['rounds']}, host {rounds['host_s'] / n * 1e3:.2f} ms a "
          f"round, device {rounds['device_s'] / n * 1e3:.2f} ms a round")

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
