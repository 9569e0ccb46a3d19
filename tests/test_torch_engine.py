"""The port's serving engine against the JAX engine on carried weights.

Greedy decoding is a pure function of (weights, prompt), so each request's
token trace must be identical in the two engines, whatever their
scheduling: with bf16 and int8 KV caches, for a prompt long enough to be
written in three prefill chunks, at 1, 2 and 4 codec frames per dispatch,
and for a burst of long prompts admitted in batched prefill rounds.  In
audio mode the PCM hops must agree too; both decode SNAC in fp32, so
samples may differ by the int16 truncation of a last-bit difference
(<= 2 LSB).  A seeded request at temperature > 0 draws from its own
stream, so its trace is the same alone, co-batched, gated and at k = 2."""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from project_morpheus_tpu.codec import SNACConfig as JaxSNACConfig
from project_morpheus_tpu.codec import init_snac_params as jax_snac_init
from project_morpheus_tpu.engine import EngineConfig as JaxEngineConfig
from project_morpheus_tpu.engine import OrpheusEngine as JaxEngine
from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model import init_llama_params as jax_init
from project_morpheus_tpu.model.quant import quantize_params_int8 as jax_quant
from project_morpheus_tpu.model.sampling import SamplingParams as JaxSampling
from project_morpheus_tpu_torch.codec import SNACConfig
from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy
from project_morpheus_tpu_torch.model.sampling import SamplingParams


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(3, 900, n).tolist() for n in (50, 6, 11)]


async def _serve(engine, sampling, prompts, audio=False):
    reqs = [await engine.submit(p, sampling, audio=audio) for p in prompts]

    async def drain(r):
        toks, pcm = [], []

        async def t():
            async for x in r.tokens():
                toks.append(x)

        async def a():
            if audio:
                async for c in r.pcm_chunks():
                    pcm.append(np.frombuffer(c, np.int16))

        await asyncio.gather(t(), a())
        return toks, pcm

    out = await asyncio.gather(*[drain(r) for r in reqs])
    await engine.close()
    return out


def _ecfg(mod, cache_dtype, **kw):
    return mod(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32), prefill_chunk=16,
               cache_dtype=cache_dtype, default_stop_ids=(7,), **kw)


@pytest.mark.parametrize("cache_dtype,quant_weights", [
    ("bfloat16", False), ("int8", False), ("int8", True)])
def test_greedy_traces_match_jax_engine(cache_dtype, quant_weights):
    jp = jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(1), dtype=jnp.float32)
    if quant_weights:
        jp = jax_quant(jp)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    prompts = _prompts()
    want = asyncio.run(_serve(
        JaxEngine(jp, JaxLlamaConfig.tiny_vocab(), _ecfg(JaxEngineConfig, cache_dtype)),
        JaxSampling(temperature=0.0, max_tokens=10, stop_token_ids=()), prompts))
    got = asyncio.run(_serve(
        OrpheusEngine(tp, LlamaConfig.tiny_vocab(), _ecfg(EngineConfig, cache_dtype),
                      device="cpu"),
        SamplingParams(temperature=0.0, max_tokens=10, stop_token_ids=()), prompts))
    for (wt, _), (gt, _) in zip(want, got):
        assert len(gt) >= 1
        assert gt == wt


def test_audio_mode_pcm_matches_jax_engine():
    cfg = JaxLlamaConfig.tiny()  # full token space: audio-band ids exist
    jp = dict(jax_init(cfg, jax.random.key(2), dtype=jnp.float32))
    lo = 128_266
    # steer greedy decoding into the audio band so the trace carries codes
    jp["embed"] = jp["embed"].at[lo:lo + 7 * 4096].multiply(10.0)
    snac = jax_snac_init(JaxSNACConfig.tiny(), seed=1)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    tsnac = params_from_jax_numpy(jax.tree.map(np.asarray, snac))
    kw = dict(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), steps_per_sync=1,
              lenient_audio_codes=True, default_stop_ids=())
    prompts = [[128259, 72, 128260], [128259, 90, 91, 128260]]
    want = asyncio.run(_serve(
        JaxEngine(jp, cfg, JaxEngineConfig(**kw), codec=(snac, JaxSNACConfig.tiny())),
        JaxSampling(temperature=0.0, max_tokens=40, stop_token_ids=()), prompts, audio=True))
    got = asyncio.run(_serve(
        OrpheusEngine(tp, LlamaConfig.tiny(), EngineConfig(**kw),
                      codec=(tsnac, SNACConfig.tiny()), device="cpu"),
        SamplingParams(temperature=0.0, max_tokens=40, stop_token_ids=()), prompts, audio=True))
    fs = SNACConfig.tiny().frame_samples
    for (wt, wp), (gt, gp) in zip(want, got):
        assert gt == wt
        assert len(gp) == len(wp) >= 5  # 40 codes: 5 frames + a padded flush
        for a, b in zip(gp, wp):
            assert a.shape == (fs,)
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 2


def _audio_setup():
    cfg = JaxLlamaConfig.tiny()  # full token space: audio-band ids exist
    jp = dict(jax_init(cfg, jax.random.key(2), dtype=jnp.float32))
    lo = 128_266
    # steer greedy decoding into the audio band so the trace carries codes
    jp["embed"] = jp["embed"].at[lo:lo + 7 * 4096].multiply(10.0)
    snac = jax_snac_init(JaxSNACConfig.tiny(), seed=1)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    tsnac = params_from_jax_numpy(jax.tree.map(np.asarray, snac))
    return cfg, jp, snac, tp, tsnac


def _assert_audio_equal(want, got):
    fs = SNACConfig.tiny().frame_samples
    for (wt, wp), (gt, gp) in zip(want, got):
        assert gt == wt
        assert len(gp) == len(wp) >= 4
        for a, b in zip(gp, wp):
            assert a.shape == (fs,)
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 2


@pytest.mark.parametrize("fpd", [1, 2, 4])
def test_traces_match_jax_engine_across_frames_per_dispatch(fpd):
    """Audio mode, 7 steps a frame, up to ``fpd`` frames a dispatch: tokens
    and PCM equal the JAX engine's (<= 2 LSB)."""
    cfg, jp, snac, tp, tsnac = _audio_setup()
    kw = dict(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), steps_per_sync=7,
              frames_per_dispatch=fpd, lenient_audio_codes=True, default_stop_ids=())
    prompts = [[128259, 72, 128260], [128259, 90, 91, 128260]]
    want = asyncio.run(_serve(
        JaxEngine(jp, cfg, JaxEngineConfig(**kw), codec=(snac, JaxSNACConfig.tiny())),
        JaxSampling(temperature=0.0, max_tokens=44, stop_token_ids=()), prompts, audio=True))
    eng = OrpheusEngine(tp, LlamaConfig.tiny(), EngineConfig(**kw),
                        codec=(tsnac, SNACConfig.tiny()), device="cpu")
    got = asyncio.run(_serve(
        eng, SamplingParams(temperature=0.0, max_tokens=44, stop_token_ids=()), prompts,
        audio=True))
    _assert_audio_equal(want, got)
    assert {key[3] for key in eng.programs.keys if key[0] != "prefill"} == {1, fpd}


def test_long_prompt_burst_takes_batched_prefill_and_matches_jax():
    """Four equal prompts of two chunks each, submitted together: the port
    admits them in J = 4 rounds, and every trace equals the JAX engine's."""
    jp = jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(1), dtype=jnp.float32)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 900, 40).tolist() for _ in range(4)]
    want = asyncio.run(_serve(
        JaxEngine(jp, JaxLlamaConfig.tiny_vocab(), _ecfg(JaxEngineConfig, "int8")),
        JaxSampling(temperature=0.0, max_tokens=8, stop_token_ids=()), prompts))
    eng = OrpheusEngine(tp, LlamaConfig.tiny_vocab(), _ecfg(EngineConfig, "int8"),
                        device="cpu")
    got = asyncio.run(_serve(
        eng, SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=()), prompts))
    assert dict(eng.prefill_rounds) == {4: 2}  # 16, then the final 24 (bucket 32), all four at once
    for (wt, _), (gt, _) in zip(want, got):
        assert len(gt) >= 1
        assert gt == wt


def test_warmup_for_single_admissions_leaves_bursts_batched():
    """A ``warmup`` at ``burst=1`` caps later lockstep rounds at J = 1, as
    the JAX engine caps them at the widest J its warmup compiled
    (``_max_batch_j``, JAX ``engine.py:1289-1290``): four equal two-chunk
    prompts run eight J = 1 rounds, and their greedy traces equal the JAX
    engine's for the same load after the same warmup."""
    jp = jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(1), dtype=jnp.float32)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, 900, 40).tolist() for _ in range(4)]
    jeng = JaxEngine(jp, JaxLlamaConfig.tiny_vocab(), _ecfg(JaxEngineConfig, "int8"))
    jeng.warmup(prompt_lens=[40], max_new_tokens=8, burst=1)
    # JAX's warmup leaves its dummy jobs' sampled tokens in last_tokens (the
    # port's clears them); a frame decoding the idle lane of a slot whose
    # prompt is between chunks writes K/V from that token at position 0, and
    # the sampled token differs by design between the packages (seeded
    # draws): start both from the cleared table
    jeng.dstate["last_tokens"] = jnp.zeros_like(jeng.dstate["last_tokens"])
    want = asyncio.run(_serve(
        jeng, JaxSampling(temperature=0.0, max_tokens=8, stop_token_ids=()), prompts))
    eng = OrpheusEngine(tp, LlamaConfig.tiny_vocab(), _ecfg(EngineConfig, "int8"),
                        device="cpu")
    eng.warmup(prompt_lens=[40], max_new_tokens=8, burst=1)
    rounds0 = dict(eng.prefill_rounds)
    got = asyncio.run(_serve(
        eng, SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=()), prompts))
    new = {j: c - rounds0.get(j, 0) for j, c in eng.prefill_rounds.items()}
    assert {j: c for j, c in new.items() if c} == {1: 8}
    for (wt, _), (gt, _) in zip(want, got):
        assert len(gt) >= 1
        assert gt == wt


def test_device_busy_time_is_the_union_of_kernel_spans():
    """Overlapping kernel spans (a dependent launch beside its producer)
    count once; disjoint and nested ones as they lie."""
    from project_morpheus_tpu_torch.tools.profile_serving import busy_seconds

    spans = [(30, 40), (0, 10), (5, 20), (6, 8), (40, 45)]
    assert busy_seconds(spans) == pytest.approx(35e-9)
    assert busy_seconds([]) == 0.0


def test_seeded_trace_independent_of_batch_gating_and_frames():
    """temperature 0.9, seed 1234: the same tokens alone, beside two
    unseeded requests, gated by a slow consumer, and at k = 2."""
    _cfg, _jp, _snac, tp, tsnac = _audio_setup()
    prompt = [128259, 72, 128260]
    sp = SamplingParams(temperature=0.9, top_p=0.95, max_tokens=35, stop_token_ids=(),
                        seed=1234)

    def engine(**kw):
        base = dict(max_slots=3, max_seq_len=256, prefill_buckets=(16, 32), steps_per_sync=7,
                    lenient_audio_codes=True, default_stop_ids=())
        return OrpheusEngine(tp, LlamaConfig.tiny(), EngineConfig(**{**base, **kw}),
                             codec=(tsnac, SNACConfig.tiny()), device="cpu", seed=3)

    async def run(eng, others=0, slow=False):
        reqs = [await eng.submit(prompt, sp, audio=True)]
        for i in range(others):
            reqs.append(await eng.submit([128259, 80 + i, 128260], dataclasses.replace(
                sp, seed=None), audio=True))
        toks = []

        async def pcm(r, slow_):
            async for _ in r.pcm_chunks():
                if slow_:
                    await asyncio.sleep(0.02)

        async def tok():
            async for t in reqs[0].tokens():
                toks.append(t)

        await asyncio.gather(tok(), *[pcm(r, slow and i == 0) for i, r in enumerate(reqs)])
        await eng.close()
        return toks

    alone = asyncio.run(run(engine()))
    assert len(alone) == 35
    assert asyncio.run(run(engine(), others=2)) == alone
    assert asyncio.run(run(engine(max_queued_hops=1), slow=True)) == alone
    assert asyncio.run(run(engine(frames_per_dispatch=2))) == alone


def test_warmup_records_every_frame_program_serving_reaches():
    """After ``warmup(prompt_lens, max_new_tokens, burst)``, serving the
    matching load (the JAX package's warmup test load) runs no frame
    program whose key warmup did not record, buckets crossed mid-stream
    included."""
    _cfg, _jp, _snac, tp, tsnac = _audio_setup()
    eng = OrpheusEngine(tp, LlamaConfig.tiny(), EngineConfig(
        max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), prefill_chunk=32,
        context_buckets=(64, 128, 256), steps_per_sync=7, frames_per_dispatch=2,
        lenient_audio_codes=True, default_stop_ids=()), codec=(tsnac, SNACConfig.tiny()),
        device="cpu", seed=5)
    n_programs = eng.warmup(prompt_lens=[20, 80], max_new_tokens=100, burst=2)
    warmed = set(eng.programs.keys)
    prefill = {k for k in warmed if k[0] == "prefill"}
    assert n_programs >= 6 and {k[0] for k in warmed - prefill} == {64, 128, 256}
    # (chunk, hist, final, J): the one chunk of 20, the two plans of 80, at J = 1 and 2
    assert {k[1:5] for k in prefill} == {
        (c, h, f, j) for c, h, f in ((32, 64, True), (32, 64, False), (16, 128, True))
        for j in (1, 2)}

    async def go():
        async def drain(*reqs):
            for r in reqs:
                async for _ in r.pcm_chunks():
                    pass

        sp = SamplingParams(temperature=0.9, max_tokens=100, stop_token_ids=())
        sp2 = SamplingParams(temperature=0.9, max_tokens=60, stop_token_ids=())
        await drain(await eng.submit(list(range(10, 30)), sp, audio=True))
        await drain(await eng.submit(list(range(10, 90)), sp2, audio=True))
        await drain(*[await eng.submit(list(range(10, 30)), sp2, audio=True) for _ in range(2)])
        await drain(*[await eng.submit(list(range(10, 90)), sp2, audio=True) for _ in range(2)])
        await eng.close()

    asyncio.run(go())
    assert eng.programs.keys <= warmed, eng.programs.keys - warmed
    served = {k for k in eng.programs.keys if k[0] == "prefill"}
    assert {k[4] for k in served} == {1, 2} and eng.prefill_rounds[2] > 0
