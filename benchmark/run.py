"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the configuration's engine from random weights made from the seed
(set-up: weights, quantization, runtime, the warmup of every shape the
cell's traffic uses, one short warm request), sends the mix's traffic for
``--seconds`` seconds, drives every request sent to its end or to the
mix's drain deadline, then checks the served tokens and PCM against the
plain reference (``lib/check.py``).  With ``--trace 0`` it prints the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``metrics/<name>.py``), as the last line of standard output, one JSON
object.  It fails without a CUDA card or with fewer cards than the cell
asks for, and if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed paths inside the checkout; no JAX through
# a library that would load it by itself
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "benchmark" / "_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "project_morpheus_tpu")
SLICE_S = 4.0  # the traced slice, at the end of the window


def forbidden_modules():
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e30
    return x


async def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
                   bench=None, t_start: float = T_START, control: bool = False, log=None,
                   mix=None):
    """One run of a cell; returns ``(result, Run, the check's verdict)``.
    ``mix`` overrides the cell's mix file (tests)."""
    import torch

    from benchmark.lib import check, drive, program, spec, traffic

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = bench or spec.load_benchmark()
    cell = spec.find_cell(bench, cell_name)
    conf = spec.load_config(bench, cell["config"])
    mix = mix or spec.load_mix(cell["traffic"])
    metrics = spec.cell_metrics(bench, cell_name, trace)
    slots = conf["engine"]["max_slots"]
    plan = traffic.plan(mix, seed, seconds, slots)

    libs_before = program.built_libraries()
    engine = program.build_engine(conf, seed, device)
    n_programs = program.warmup(engine, mix, plan["items"])
    fs = engine._codec[1].frame_samples
    hop_audio_s = fs / conf["codec"]["sampling_rate"]
    short = min(plan["items"], key=lambda i: len(i.prompt))
    warm = traffic.Item(0.0, short.prompt, 2, True, 1)
    await drive.window(engine, mix, {"loop": "open", "items": [warm]}, 0.0, 2 * fs)
    captures0 = engine.programs.captures
    tracer = None
    if trace:
        from benchmark.lib.trace import Tracer

        tracer = Tracer(engine, min(SLICE_S, seconds / 2), mix.get("trace_slice_start_s"))
        tracer.warm_profiler()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    res = await drive.window(engine, mix, plan, seconds, 2 * fs,
                             on_open=tracer.open if tracer else None,
                             slice_task=tracer.slice_task if tracer else None)
    setup_s = res["t0"] - t_start
    if tracer is not None:
        tracer.close()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    captures = engine.programs.captures - captures0
    geometry = {"slots": slots, "steps_per_sync": engine.steps_per_sync,
                "graph_pool_bytes": engine.programs.pool_bytes()}
    await engine.close()
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    reqs = res["records"]
    # the family's sizes, named by it, whose counts the readers reach (lib/counts.py)
    d = dict(spec.family(conf).weights.dims(conf), family=spec.family_name(conf))
    run = Run(conf=conf, mix=mix, cell=cell, d=d, records=reqs, t0=res["t0"], t1=res["t1"],
              deadline=res["deadline"], seconds=seconds, setup_s=setup_s,
              hop_audio_s=hop_audio_s, tracer=tracer, **geometry)
    out_metrics = {}
    for m in metrics:
        value = spec.load_reader(m["name"]).read(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = check.run(conf, mix, seed, device, reqs, control=control)

    late = sorted(res["late_s"])
    log(f"requests: {len(reqs)} sent, {sum(r['failed'] for r in reqs)} failed; generator "
        f"late by median {late[len(late) // 2] * 1e3:.3f} ms, max {late[-1] * 1e3:.3f} ms")
    for r in reqs:
        if r["failed"]:
            log(f"  failed request at {r['t_sched'] - res['t0']:.3f} s: {r['why']}")
    built = program.built_libraries() - libs_before
    log(f"set-up {setup_s:.3f} s ({built} kernel libraries built in it: "
        f"{'the first run in this checkout' if built else 'all found built'}): "
        f"{n_programs} programs warmed; graph pool "
        f"{geometry['graph_pool_bytes'] / 2**30:.3f} GiB; graphs captured in the window: "
        f"{captures}; peak memory {peak / 2**30:.3f} GiB")
    if tracer is not None and tracer.trace:
        log(f"traced slice {tracer.trace.get('window_s', 0):.3f} s (the profiler took "
            f"{tracer.trace.get('start_s', 0):.3f} s to start), device busy "
            f"{tracer.trace['busy_s']:.3f} s")
    log("check detail: " + json.dumps(verdict["detail"]))
    result = {"correct": verdict["correct"], "attempted": len(reqs),
              "failed": sum(1 for r in reqs if r["failed"]), "metrics": out_metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if tracer is not None and tracer.trace.get("busy_s"):
        t = tracer.trace
        result["device"].update({"busy_s": t["busy_s"], "window_s": t["window_s"]})
        ops = sorted(((n, v[0]) for n, v in t["ops"].items()), key=lambda x: -x[1])[:10]
        gaps = sorted(t["gaps"].items(), key=lambda x: -x[1])[:10]
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in ops],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in verdict["checks"].items()}
    return result, run, verdict


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.lib import spec

    bench = spec.load_benchmark()
    chips = spec.find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, _, _ = asyncio.run(run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda", bench))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
