"""Where a serving run's time goes on the card.

    python -m project_morpheus_tpu_torch.tools.profile_serving

Builds the serving runtime of ``SERVING_ENV`` (Orpheus-3B, int8 weights,
int8 KV cache, 8 slots x 8192, banded sampling), warms it with one short
request, then serves ``PROMPTS`` (one ~2,500-token prompt and three short
ones), ``TOKENS_PER_REQUEST`` tokens each, twice:

1. unprofiled: wall time, and host time per engine phase (decode frames,
   prefill chunks, routing) from the host clock around each call (each
   ends in a device sync);
2. under ``torch.profiler`` tracing the card only: device time by kernel
   name, and the device's busy share of that window (the tracer adds
   some host time of its own).

Then prints the card's name and power limit.  ``chip_smoke.py`` serves
the same workload through ``serving_runtime`` and these constants.

It needs a CUDA card and fails without one.
"""
from __future__ import annotations

import asyncio
import collections
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
TOP_KERNELS = 30


def serving_runtime(**kw):
    """Build the ``SERVING_ENV`` runtime on the card (``kw`` goes to
    ``ServingRuntime``) and make it the process's runtime."""
    from ..adapters import runtime as rt

    os.environ.update(SERVING_ENV)
    runtime = rt.ServingRuntime(device="cuda", banded_sampling=True, **kw)
    runtime.build()
    rt.set_runtime(runtime)
    return runtime


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


async def _main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = serving_runtime().engine
    await _serve(["Warm up."], 14)
    totals = collections.defaultdict(lambda: [0.0, 0])
    for name in ("_dispatch_frame", "_advance_prefill", "_process_frame"):
        _wrap(eng, name, totals)
    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcm = await _serve(PROMPTS, TOKENS_PER_REQUEST)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = eng.steps - steps0
    print(f"unprofiled: {wall:.3f} s wall, {steps} decode steps, {sum(pcm)} PCM bytes, "
          f"{wall / max(steps, 1) * 1e3:.2f} ms per step over the window")
    for name, (secs, n) in totals.items():
        print(f"  host {name}: {secs:.3f} s in {n} calls ({secs / max(n, 1) * 1e3:.2f} ms/call)")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        await _serve(PROMPTS, TOKENS_PER_REQUEST)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    await eng.close()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profiled: {wall:.3f} s wall, device busy {busy:.3f} s ({100 * busy / wall:.1f}%)")
    for dev_us, count, key in rows[:TOP_KERNELS]:
        print(f"  {dev_us / 1e3:10.2f} ms {100 * dev_us / 1e6 / busy:5.1f}% {count:7d}x  {key[:110]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    asyncio.run(_main())


if __name__ == "__main__":
    main()
