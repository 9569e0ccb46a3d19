"""Shared fixtures of the benchmark's own tests (run with
``python -m pytest benchmark/tests``; the repository's tier-1 run does
not collect them)."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA card (decided here, not at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_bench():
    """A bench whose one cell serves the tiny test configuration."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = {"configs": [{"name": "tiny", "file": "benchmark/tests/tiny.json"}],
             "workloads": [{"name": "tiny-chat", "config": "tiny", "traffic": "chat_greedy",
                            "chips": 1}],
             "end_to_end": copy.deepcopy(real["end_to_end"]),
             "per_layer": copy.deepcopy(real["per_layer"])}
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench


def tiny_mix(rate: float = 2.0):
    from benchmark.lib import spec

    mix = spec.load_mix("chat_greedy")
    mix["arrival"]["rate_per_s"] = rate
    mix["prompt"]["length"].update(max=100)
    mix["output_frames"].update(min=3, max=8, median=4)
    mix["check"]["greedy_tokens"] = 60
    mix["drain_s"] = 60
    return mix


@pytest.fixture
def tiny():
    return tiny_bench(), tiny_mix()
