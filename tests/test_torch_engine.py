"""The port's serving engine against the JAX engine on carried weights.

Greedy decoding is a pure function of (weights, prompt), so each request's
token trace must be identical in the two engines, whatever their
scheduling: with bf16 and int8 KV caches, and for a prompt long enough to
be written in three prefill chunks.  In audio mode the PCM hops must agree
too; both decode SNAC in fp32, so samples may differ by the int16
truncation of a last-bit difference (<= 2 LSB)."""
import asyncio

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


@pytest.mark.parametrize("fpd", [0, 1, 4])
def test_frames_per_dispatch_above_one_raises(fpd):
    tp = params_from_jax_numpy(jax.tree.map(
        np.asarray, jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(1), dtype=jnp.float32)))
    ecfg = _ecfg(EngineConfig, "bfloat16", frames_per_dispatch=fpd)
    if fpd > 1:
        with pytest.raises(ValueError, match="multi-frame dispatch"):
            OrpheusEngine(tp, LlamaConfig.tiny_vocab(), ecfg, device="cpu")
    else:
        assert OrpheusEngine(tp, LlamaConfig.tiny_vocab(), ecfg, device="cpu").ecfg is ecfg


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
