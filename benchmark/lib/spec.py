"""The benchmark's files, found by name.

``BENCHMARK.json`` (at the repository root) lists the cells and metrics;
each cell names a configuration (``configs/<file>``, by the path the
configuration's entry gives) and a traffic mix (``mixes/<name>.json``);
each metric is read by ``metrics/<name>.py`` (or, for a quantity split
by name, by the metric it moves or by the bound its cells need, by the
file of the part before the dot); each configuration's decoder is built,
weighed and referenced by its family, ``families/<family>/`` (the
configuration's key ``family``; ``llama`` where it has none).
Nothing here names a particular cell, mix or metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
DEFAULT_FAMILY = "llama"
FAMILY_MODULES = ("weights", "program", "reference")


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


def _family_module(name: str, module: str):
    """``benchmark.families.<name>.<module>``; KeyError naming the file
    looked for where the family or the module is not there."""
    from benchmark import families

    qual = f"{families.__name__}.{name}.{module}"
    try:
        return importlib.import_module(qual)
    except ModuleNotFoundError as e:
        if e.name is None or not (qual == e.name or qual.startswith(e.name + ".")):
            raise
        looked = ", ".join(str(Path(d) / name / f"{module}.py") for d in families.__path__)
        raise KeyError(f"no decoder family {name!r} with {module}.py: no {looked}") from None


def load_family(name: str):
    """The decoder family ``families/<name>/``, the package
    ``benchmark.families.<name>`` with its three modules loaded:
    ``weights`` (``dims(conf)``, ``weights(conf, seed, device, dtype)``),
    ``program`` (``engine_inputs(conf, params)``) and ``reference``
    (``logits(weights, d, seqs, weight_bits)``)."""
    mods = [_family_module(name, m) for m in FAMILY_MODULES]
    return sys.modules[mods[0].__package__]


def family_counts(name: str):
    """The family's ``counts.py``: the operations and bytes its decoder's
    work needs (``lib/counts.py`` forwards to it)."""
    return _family_module(name, "counts")


def family_name(conf: Dict) -> str:
    """The family a configuration names under ``family``."""
    return conf.get("family", DEFAULT_FAMILY)


def family(conf: Dict):
    """The family a configuration names, loaded."""
    return load_family(family_name(conf))
