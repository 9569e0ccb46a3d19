"""The benchmark's files, found by name.

``BENCHMARK.json`` (at the repository root) lists the cells and metrics;
each cell names a configuration (``configs/<file>``, by the path the
configuration's entry gives) and a traffic mix (``mixes/<name>.json``);
each metric is read by ``metrics/<name>.py`` (or, for a quantity split
by name, by the metric it moves or by the bound its cells need, by the
file of the part before the dot).
Nothing here names a particular cell, mix or metric.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for conf in bench["configs"]:
        if conf["name"] == name:
            return json.loads((root / conf["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_mix(name: str) -> Dict:
    path = BENCH_DIR / "mixes" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix file {path}")
    return json.loads(path.read_text())


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    (``--trace 0``) or its per-layer metrics (``--trace 1``).  A metric
    without ``workloads`` belongs to every cell; a per-layer metric
    without it, to every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def load_reader(name: str):
    """The module ``metrics/<name>.py``, or for a quantity split by name
    (``frame_device_ms.chat``, ``audio_s_per_s.clone``) ``metrics/<the part
    before the first dot>.py``; its ``read(run)`` returns the metric's
    value, or None when the run has nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise KeyError(f"no metric reader for {name!r} in {BENCH_DIR / 'metrics'}")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
