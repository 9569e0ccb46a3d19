"""The decoder-family seam: the llama family draws and scores what the
harness drew and scored before it moved behind the seam, and a family
added as files alone runs a cell to ``correct``."""
import asyncio
import json
import shutil
from types import SimpleNamespace

import numpy as np
import torch

import benchmark.families
from benchmark import run as bench_run
from benchmark.lib import check, spec
from benchmark.tests.conftest import ROOT, tiny_bench, tiny_mix

TINY = json.loads((ROOT / "benchmark" / "tests" / "tiny.json").read_text())

# float64 sums of each leaf of the tiny configuration's weights at seed 5
# (CPU, float32) and the gaps of three fixed sequences, as the harness gave
# them with the Llama block's weights and reference in lib/ and reference/
LEAF_SUMS = {
    "embed": -39.074418808073894, "ln_f": 63.516102731227875, "ln1": 128.12569797039032,
    "wq": 10.839589724339021, "wk": -7.097607430576318, "wv": -7.36292461251287,
    "wo": 10.665090911863444, "ln2": 127.73599129915237, "wg": 3.799992892958471,
    "wu": 9.199574383696927, "wd": 9.432658411824377, "lm_head": -124.72850445268733,
}
GAPS = [
    {"tokens": 7, "gap": 5.564830780029297, "control_gap": 1.0537018775939941},
    {"tokens": 14, "gap": 5.658332347869873, "control_gap": 1.1484534740447998},
    {"tokens": 21, "gap": 5.579827308654785, "control_gap": 1.4376485347747803},
]


def _leaves(w):
    out = {k: v for k, v in w.items() if k != "layers"}
    out.update(w["layers"])
    return out


def test_llama_family_draws_the_same_weights():
    fam = spec.family(TINY)
    w = _leaves(fam.weights.weights(TINY, 5, "cpu", torch.float32))
    assert {k: v.double().sum().item() for k, v in w.items()} == LEAF_SUMS


def test_llama_family_reference_gives_the_same_gaps():
    fam = spec.family(TINY)
    rng = np.random.default_rng(17)
    recs = []
    for P, T in ((10, 7), (17, 14), (25, 21)):
        prompt = rng.integers(0, 128000, P).tolist()
        toks = [128266 + (j % 7) * 4096 + int(c) for j, c in enumerate(rng.integers(0, 4096, T))]
        recs.append({"item": SimpleNamespace(prompt=prompt), "tokens": toks})
    w = fam.weights.weights(TINY, 5, "cpu", torch.float32)
    rows = check.logit_readings(fam.reference, w, fam.weights.dims(TINY), recs, 1.1,
                                control_bits=4)
    assert rows == GAPS


def test_a_family_added_as_files_runs_a_cell(tmp_path, monkeypatch):
    """A copy of the llama family under another name, and a copy of the
    tiny configuration that names it: a cell runs to ``correct`` through
    the copy, with no file of the harness changed."""
    shutil.copytree(ROOT / "benchmark" / "families" / "llama", tmp_path / "families" / "copied",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf_file = tmp_path / "copied.json"
    conf_file.write_text(json.dumps(dict(TINY, family="copied")))
    llama_dims = spec.family(TINY).weights.dims(TINY)
    monkeypatch.setattr(benchmark.families, "__path__",
                        [*benchmark.families.__path__, str(tmp_path / "families")])
    bench = tiny_bench()
    bench["configs"][0]["file"] = str(conf_file)
    res, run, _ = asyncio.run(bench_run.run_cell("tiny-chat", 11, 2.0, False, "cpu", bench,
                                                 mix=tiny_mix(), log=lambda *a: None))
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert run.d == dict(llama_dims, family="copied")
    assert spec.family(run.conf).weights.__file__.startswith(str(tmp_path))
