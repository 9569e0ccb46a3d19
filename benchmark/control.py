"""The readings the correctness limits are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, in one process: a run of the cell at its own load (set-up,
the window, the drain), then the check's numbers for the program beside
its controls: ``logit_gap`` beside ``control_gap``, the gap of the tokens
that the configuration's family's reference puts first with int4 weights
in place of the int8 the configuration states; ``pcm_lsb`` beside
``control_lsb``, the reference's SNAC decode in TF32 against its fp32
decode.  One JSON line a seed.  The
benchmark's own runs never compute the controls.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


async def readings(cell: str, seeds, seconds: float, device: str = "cuda"):
    from benchmark import run as bench_run

    for seed in seeds:
        t = time.perf_counter()
        res, _, verdict = await bench_run.run_cell(cell, seed, seconds, False, device,
                                                   t_start=t, control=True)
        det = verdict["detail"]
        print(json.dumps({
            "seed": seed, "correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "logit_gap": max((r["gap"] for r in det.get("logit", [])), default=None),
            "control_gap": max((r["control_gap"] for r in det.get("logit", [])), default=None),
            "pcm_lsb": max((r["lsb"] for r in det.get("pcm", [])), default=None),
            "control_lsb": max((r["control_lsb"] for r in det.get("pcm", [])), default=None),
            "detail": det, "seconds": time.perf_counter() - t}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    asyncio.run(readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
