"""Frame programs replayed from CUDA graphs against the same programs run
eagerly, on one small int8 model on the card.

``graph_and_eager_traces(device, temperature)`` serves the same seeded
requests through an engine that replays captured graphs and through one
that runs its frame programs eagerly (a ``ProgramCache`` without graphs),
and returns both engines' token traces and program caches.  The traces
must be identical: the kernels are deterministic and every random draw is
a function of (seed, draw counter).  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` call it.
"""
from __future__ import annotations

import asyncio

import torch

PROMPTS = [[5 + i, 17, 300 + 7 * i, 9] * (3 + 4 * i) for i in range(3)]
MAX_TOKENS = 40


def small_config(**kw):
    """Two layers of 3B-like heads (HD=128, G=3); ``kw`` overrides fields."""
    from ..model import LlamaConfig

    return LlamaConfig(**{**dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
                                 num_layers=2, num_heads=6, num_kv_heads=2, head_dim=128,
                                 max_seq_len=512, rope_scaling_factor=1.0), **kw})


def small_engine(device, graphs: bool, params=None, cfg=None):
    """An engine over ``small_config()`` (or ``cfg``) with random weights
    (or ``params``), quantized to int8, an int8 cache, the slot kernel in
    decode."""
    from ..engine import EngineConfig, OrpheusEngine
    from ..engine.graphs import ProgramCache
    from ..model.llama import init_llama_params
    from ..model.quant import quantize_params_int8

    cfg = cfg or small_config()
    if params is None:
        params = init_llama_params(cfg, 7, device, torch.bfloat16)
    params = quantize_params_int8(params)
    ecfg = EngineConfig(max_slots=4, max_seq_len=512, prefill_buckets=(32, 64), prefill_chunk=64,
                        context_buckets=(128, 256, 512), cache_dtype="int8", attn_impl="kernel",
                        default_stop_ids=())
    engine = OrpheusEngine(params, cfg, ecfg, device=device)
    engine.programs = ProgramCache(engine.device, graphs=graphs)
    return engine


def serve_traces(engine, temperature: float):
    """Serve ``PROMPTS`` (seeded) on ``engine`` and close it: (token
    traces, its ProgramCache)."""
    from ..model.sampling import SamplingParams

    async def serve():
        reqs = [await engine.submit(p, SamplingParams(temperature=temperature,
                                                      max_tokens=MAX_TOKENS,
                                                      stop_token_ids=(), seed=11 + i))
                for i, p in enumerate(PROMPTS)]

        async def drain(r):
            return [t async for t in r.tokens()]

        out = await asyncio.gather(*[drain(r) for r in reqs])
        await engine.close()
        return out, engine.programs

    return asyncio.run(serve())


def graph_and_eager_traces(device, temperature: float):
    """((graph traces, graph ProgramCache), (eager traces, eager cache))."""
    return (serve_traces(small_engine(device, True), temperature),
            serve_traces(small_engine(device, False), temperature))
