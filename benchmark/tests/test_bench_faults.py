"""The check fails a run whose timed path is broken underneath, once for
each fault a serving cell can have, and its control comes out not
correct: the CPU at the tiny configuration, the card where it needs one."""
import asyncio
import importlib

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.lib.weights import snac_weights
from benchmark.reference import scoring
from benchmark.reference import snac as ref_snac
from benchmark.tests.conftest import tiny_bench, tiny_mix

ENGINE = "project_morpheus_tpu_torch.engine.engine"


def _all_greedy():
    mix = tiny_mix(rate=3.0)
    mix["greedy_every"] = 1
    mix["check"]["greedy_tokens"] = 10_000
    mix["check"]["pcm_requests"] = 100
    return mix


def _run(mix, control=False):
    return asyncio.run(bench_run.run_cell("tiny-chat", 2**32 + 3, 3.0, False, "cpu",
                                          tiny_bench(), mix=mix, control=control,
                                          log=lambda *a: None))


def test_sound_run_is_correct():
    res, _, verdict = _run(_all_greedy())
    assert res["correct"], res["checks"]
    assert verdict["detail"]["greedy_requests"] == res["attempted"]


def _token_altered(mod):
    orig = mod.sample_logits

    def f(*a, **k):
        return orig(*a, **k) + 1

    return f


def _state_unchanged(mod):
    orig = mod.llama_decode_step

    def f(params, tokens, cfg, cache, *a, **k):
        return orig(params, tokens, cfg, {n: t.clone() for n, t in cache.items()}, *a, **k)

    return f


def _half_batch_left_out(mod):
    orig = mod.llama_decode_step

    def f(*a, **k):
        lg = orig(*a, **k)
        half = lg.shape[0] // 2
        return torch.cat([lg[:half], lg[:half]])

    return f


def _pcm_altered(mod):
    orig = mod.snac_stream_body

    def f(*a, **k):
        pcm, state = orig(*a, **k)
        return pcm + 50, state

    return f


@pytest.mark.parametrize("name,target,fault", [
    ("token altered where produced", "sample_logits", _token_altered),
    ("a step that returns its state unchanged", "llama_decode_step", _state_unchanged),
    ("half of the batch left out", "llama_decode_step", _half_batch_left_out),
    ("PCM altered where produced", "snac_stream_body", _pcm_altered),
])
def test_fault_makes_the_run_incorrect(monkeypatch, name, target, fault):
    mod = importlib.import_module(ENGINE)
    monkeypatch.setattr(mod, target, fault(mod))
    res, _, _ = _run(_all_greedy())
    assert not res["correct"], (name, res["checks"])


def test_int4_control_fails_the_logit_limit():
    """The control (int4 weights in the reference, in the program's place)
    reads above the limit; the program below it."""
    res, _, verdict = _run(_all_greedy(), control=True)
    limit = res["checks"]["logit_gap"]["limit"]
    rows = verdict["detail"]["logit"]
    assert max(r["gap"] for r in rows) <= limit < min(r["control_gap"] for r in rows)


def test_tf32_control_fails_the_pcm_limit(cuda):
    """On the card: TF32 in the reference's SNAC decode, in the program's
    place, reads above the PCM limit at the configuration's full width."""
    from benchmark.lib import spec

    conf = spec.load_config(spec.load_benchmark(), "smollm2-1.7b")
    snac = snac_weights(conf["codec"], 5, cuda)
    codes = np.random.default_rng(5).integers(0, 4096, size=7 * 16)
    with scoring.exact_fp32():
        want = ref_snac.stream_hops(snac, conf["codec"], codes)
    with scoring.exact_fp32(tf32=True):
        got = ref_snac.stream_hops(snac, conf["codec"], codes)
    lsb = max(int(np.abs(a.astype(np.int64) - b).max()) for a, b in zip(got, want))
    assert lsb > conf["limits"]["pcm_lsb"]
