"""Find an open-loop cell's knee, once, on the card:

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> --rates r1,r2,...

One set-up (the cell's configuration, warmed for every rate's shapes),
then a window at each offered rate in turn, from the lowest.  For each
rate it prints one JSON line: requests sent and failed, TTFA p50 and p90,
``stream_rtf_p10``, the share of requests that met the mix's limits
(``limits.ttfa_ms``, ``limits.stream_rtf``; a failed request meets
neither), and whether a backlog grew (the TTFA median of the window's
last third of requests over twice that of its first third, and above
the limit).  The knee is the highest rate at which 90% meet the limits
with no growing backlog; where no rate meets them, it is the highest rate
with no growing backlog (``knee_by`` says which).  The last line gives
the cell's rate, 0.8 x the knee, which goes into the mix file.  With
``limits.ttfa_idle_factor`` in the mix, the TTFA limit is that factor
times the idle engine's TTFA at the mix's longest prompt, measured first.
"""
from __future__ import annotations

import argparse
import asyncio
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def judge(records, deadline, limits, hop_audio_s):
    from benchmark.lib.stats import nearest_rank, stream_rtf, ttfa_ms

    tt = ttfa_ms(records, deadline)
    rtf = stream_rtf(records, hop_audio_s)
    met = sum(1 for t, r in zip(tt, rtf) if t <= limits["ttfa_ms"] and r >= limits["stream_rtf"])
    third = max(1, len(tt) // 3)
    first, last = sorted(tt[:third]), sorted(tt[-third:])
    growing = (last[len(last) // 2] > 2 * first[len(first) // 2]
               and last[len(last) // 2] > limits["ttfa_ms"])
    return {"sent": len(records), "failed": sum(r["failed"] for r in records),
            "ttfa_p50_ms": nearest_rank(tt, 50), "ttfa_p90_ms": nearest_rank(tt, 90),
            "stream_rtf_p10": nearest_rank(rtf, 10), "met": met / len(records),
            "growing": growing}


def knee(rows):
    """The knee of a ladder of judged rates, the criterion that set it, and
    the cell's rate, 0.8 x the knee."""
    steady = [r["rate_per_s"] for r in rows if not r["growing"]]
    within = [r["rate_per_s"] for r in rows if not r["growing"] and r["met"] >= 0.9]
    k, by = (max(within), "limits") if within else \
        (max(steady), "no growing backlog") if steady else (None, None)
    return {"knee_per_s": k, "knee_by": by,
            "rate_per_s": None if k is None else round(0.8 * k, 3)}


async def sweep(cell_name: str, seed: int, seconds: float, rates, device: str = "cuda"):
    import torch

    from benchmark.lib import drive, program, spec, traffic

    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, cell_name)
    conf = spec.load_config(bench, cell["config"])
    mix = spec.load_mix(cell["traffic"])
    slots = conf["engine"]["max_slots"]
    plans = []
    for r in rates:
        m = copy.deepcopy(mix)
        m["arrival"]["rate_per_s"] = r
        plans.append((r, traffic.plan(m, seed + int(r * 1000), seconds, slots)))
    every = [i for _, p in plans for i in p["items"]]
    engine = program.build_engine(conf, seed, device)
    t = time.perf_counter()
    n = program.warmup(engine, mix, every)
    print(json.dumps({"warmup_programs": n, "warmup_s": time.perf_counter() - t}), flush=True)
    fs = engine._codec[1].frame_samples
    hop_audio_s = fs / conf["codec"]["sampling_rate"]
    limits = dict(mix["limits"])
    longest = max(every, key=lambda i: len(i.prompt))
    idle = []
    for k in range(3):  # the idle engine's TTFA at the longest prompt
        item = traffic.Item(0.0, longest.prompt, 12, True, k)
        res = await drive.window(engine, mix, {"loop": "open", "items": [item]}, 0.0, 2 * fs)
        rec = res["records"][0]
        idle.append((rec["hops"][0] - rec["t_sched"]) * 1e3)
    if "ttfa_idle_factor" in limits:
        limits["ttfa_ms"] = limits["ttfa_idle_factor"] * min(idle)
    print(json.dumps({"idle_ttfa_ms_longest_prompt": idle, "prompt": len(longest.prompt),
                      "limits": limits}), flush=True)
    rows = []
    for r, plan in plans:
        res = await drive.window(engine, mix, plan, seconds, 2 * fs)
        row = judge(res["records"], res["deadline"], limits, hop_audio_s)
        row["rate_per_s"] = r
        late = sorted(res["late_s"])
        row["late_ms_max"] = late[-1] * 1e3
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({**knee(rows),
                      "card": torch.cuda.get_device_name(0) if device == "cuda" else device}),
          flush=True)
    await engine.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    asyncio.run(sweep(args.workload, args.seed, args.seconds,
                      [float(x) for x in args.rates.split(",")]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
