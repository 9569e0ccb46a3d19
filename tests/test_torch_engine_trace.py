"""The engine's in-memory trace (``engine/trace.py``) on the CPU.

Off, it records nothing and builds no trace object; on, the served tokens
and PCM are the same bits.  Each request's three phase spans are
contiguous and sum to its submit-to-first-hop interval, which lies inside
the client's own; loop spans nest; a frame program's marks, taken on the
host clock here, give stages that sum to its first-to-last mark; the lane
counters equal the tokens routed and steps x ``max_slots``, and the
attention and trunk counters count every frame under its path.  The card's
side (timestamps written inside a captured graph) is in
``tests/test_torch_cuda.py``."""
import asyncio
import time

import numpy as np
import pytest
import torch

from project_morpheus_tpu_torch.codec import SNACConfig
from project_morpheus_tpu_torch.codec.weights import init_snac_params
from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
from project_morpheus_tpu_torch.engine import engine as engine_mod
from project_morpheus_tpu_torch.engine import trace as trace_mod
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model.llama import init_llama_params
from project_morpheus_tpu_torch.model.sampling import SamplingParams
from project_morpheus_tpu_torch.tools import profile_serving

FRAMES = 3
STEPS = 7
PROMPTS = [[128259, 72, 128260], [128259, 90, 91, 128260], [128259] + [40 + i for i in range(40)],
           [128259, 11, 12, 13, 128260]]
LOOP_SPANS = {"engine.turn", "engine.admit", "engine.gate", "engine.dispatch",
              "engine.stage_inputs", "engine.replay", "engine.readback_issue",
              "engine.prefill_round", "engine.readback_wait", "engine.route",
              "engine.flush_audio", "engine.park"}


def _engine(dtype=torch.float32, **kw):
    cfg = LlamaConfig.tiny()
    ecfg = EngineConfig(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), prefill_chunk=16,
                        context_buckets=(64, 128, 256), steps_per_sync=STEPS,
                        banded_sampling=True, default_stop_ids=(), **kw)
    snac = init_snac_params(SNACConfig.tiny(), seed=1, device="cpu")
    return OrpheusEngine(init_llama_params(cfg, 3, "cpu", dtype), cfg, ecfg,
                         codec=(snac, SNACConfig.tiny()), device="cpu")


def _serve(trace: bool, dtype=torch.float32):
    """Serve ``PROMPTS`` greedily in audio mode (four requests, two slots:
    two of them queue) from weights in ``dtype``; returns (engine,
    [(request, tokens, pcm, client ns of the first hop)])."""
    eng = _engine(dtype)
    if trace:
        eng.start_trace()

    async def run():
        sp = SamplingParams(temperature=0.0, max_tokens=FRAMES * 7, stop_token_ids=())
        reqs = [await eng.submit(p, sp, audio=True) for p in PROMPTS]

        async def drain(r):
            pcm, first = [], None
            async for c in r.pcm_chunks():
                first = first or time.perf_counter_ns()
                pcm.append(np.frombuffer(c, np.int16))
            toks = []
            while not r.token_queue.empty():
                t = r.token_queue.get_nowait()
                if t is not None:
                    toks.append(t)
            return r, toks, pcm, first

        out = await asyncio.gather(*[drain(r) for r in reqs])
        await eng.close()
        return out

    return eng, asyncio.run(run())


@pytest.fixture(scope="module")
def traced():
    return _serve(True)


def test_trace_off_records_nothing_and_serves_the_same_bits(traced, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a trace object was built with the trace off")

    monkeypatch.setattr(engine_mod, "EngineTrace", refuse)
    monkeypatch.setattr(engine_mod, "Stamps", refuse)
    eng, plain = _serve(False)
    assert eng.trace is None
    _, on = traced
    for (_, t_off, p_off, _), (_, t_on, p_on, _) in zip(plain, on):
        assert len(t_off) == FRAMES * 7 and t_off == t_on
        assert len(p_off) == FRAMES and all(np.array_equal(a, b) for a, b in zip(p_off, p_on))


def test_request_phases_are_contiguous_and_sum_to_the_first_hop(traced):
    eng, served = traced
    spans = eng.trace.spans
    for req, _, _, client_first in served:
        mine = [s for s in spans if s.request_id == req.request_id]
        (top,) = [s for s in mine if s.name == "request"]
        phases = sorted((s for s in mine if s.parent == top.id), key=lambda s: s.start_ns)
        assert [s.name for s in phases] == list(trace_mod.REQUEST_PHASES)
        assert phases[0].start_ns == top.start_ns
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns == b.start_ns
        assert all(s.end_ns >= s.start_ns for s in phases)
        total = sum(s.end_ns - s.start_ns for s in phases)
        assert total == phases[-1].end_ns - top.start_ns
        # the engine's interval lies inside the client's (sent before
        # submit, received after the hop was put on the queue)
        assert phases[-1].end_ns <= client_first and top.end_ns >= phases[-1].end_ns
    # two slots, four requests: the last two waited for a slot
    waits = sorted(s.end_ns - s.start_ns for s in spans if s.name == "request.queue")
    assert waits[-1] > 0


def test_loop_spans_nest(traced):
    eng, _ = traced
    loop = [s for s in eng.trace.spans if s.request_id is None]
    by_id = {s.id: s for s in loop}
    assert {s.name for s in loop} <= LOOP_SPANS
    assert {"engine.turn", "engine.dispatch", "engine.replay", "engine.route",
            "engine.prefill_round", "engine.readback_wait"} <= {s.name for s in loop}
    for s in loop:
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for s in loop:
        if s.name == "engine.turn":
            assert s.parent is None
        elif s.name in ("engine.replay", "engine.stage_inputs"):
            assert by_id[s.parent].name in ("engine.dispatch", "engine.prefill_round")
        elif s.name == "engine.dispatch":
            assert by_id[s.parent].name == "engine.turn"


def test_lane_counters_equal_the_tokens_routed(traced):
    eng, served = traced
    c = eng.trace.counters
    assert c["lanes_decoded"] == eng.steps * eng.ecfg.max_slots
    # each request's first token comes from its prefill, the rest from frames
    assert c["lanes_emitted"] == sum(len(t) - 1 for _, t, _, _ in served) > 0
    assert len(eng.trace.frames) == eng.steps // STEPS
    # on the CPU "auto" resolves to the dense branch for every frame; fp32
    # activations keep the trunk's plain ops
    assert c["attn_dense_frames"] == eng.steps // STEPS and c["attn_kernel_frames"] == 0
    assert c["trunk_plain_frames"] == eng.steps // STEPS and c["trunk_kernel_frames"] == 0


def test_trunk_counters_count_the_kernel_path_in_bf16():
    """bf16 weights and cache: every frame dispatched runs the trunk's
    wrappers (their twins on the CPU), and the trace counts it so."""
    eng, served = _serve(True, torch.bfloat16)
    c = eng.trace.counters
    assert all(len(t) == FRAMES * 7 for _, t, _, _ in served)
    assert eng._trunk_path() == "kernel"
    assert c["trunk_kernel_frames"] == eng.steps // STEPS > 0 and c["trunk_plain_frames"] == 0
    assert c["attn_dense_frames"] == eng.steps // STEPS


@pytest.mark.parametrize("audio,k", [(True, 1), (True, 2), (False, 1)])
def test_frame_marks_give_stages_that_sum_to_the_frame(audio, k):
    eng = _engine(frames_per_dispatch=k)
    eng.start_trace()
    outs = eng._run_program(64, k, audio)
    assert len(outs) == (4 if audio else 2)
    marks = outs[-1].numpy()
    names = list(trace_mod.MARKS)
    L = eng.cfg.num_layers
    step = ["step"] + ["attn_in", "attn_out"] * L + ["trunk", "sampled", "bookkept"]
    frame = ["frame"] + step * STEPS + (["snac"] if audio else [])
    assert [names[c] for c in marks[:, 0]] == frame * k + ["end"]
    assert np.all(np.diff(marks[:, 1]) >= 0)
    st = trace_mod.stage_ns(marks)
    assert st["frames"] == k and all(st[s] >= 0 for s in trace_mod.STAGES)
    assert sum(st[s] for s in trace_mod.STAGES) == marks[-1, 1] - marks[0, 1]
    assert (st["snac"] > 0) == audio and st["attention"] > 0 and st["sampling"] > 0


def test_stage_ns_assigns_each_interval_to_the_mark_that_ends_it():
    c = trace_mod.CODES
    marks = np.array([[c["frame"], 100], [c["step"], 101], [c["attn_in"], 110],
                      [c["attn_out"], 150], [c["trunk"], 170], [c["sampled"], 200],
                      [c["bookkept"], 204], [c["snac"], 300], [c["end"], 301]], np.int64)
    assert trace_mod.stage_ns(marks) == {"attention": 40, "trunk": 9 + 20, "sampling": 30,
                                         "bookkeeping": 1 + 4 + 1, "snac": 96, "frames": 1}


def test_round_timer_reads_the_engines_prefill_spans():
    eng = _engine()

    async def run():
        sp = SamplingParams(temperature=0.0, max_tokens=7, stop_token_ids=())
        with profile_serving.round_timer(eng) as rounds:
            r = await eng.submit(PROMPTS[2], sp, audio=True)
            async for _ in r.pcm_chunks():
                pass
        await eng.close()
        return rounds

    rounds = asyncio.run(run())
    # 41 prompt ids: a chunk of 16, then the last 25 in the 32 bucket
    assert rounds["rounds"] == 2 and rounds["host_s"] > 0 and rounds["device_s"] == 0.0
    assert eng.trace is None  # the timer turned on the trace, and off again
