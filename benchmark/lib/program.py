"""The system under test: ``project_morpheus_tpu_torch``'s engine, built
as its ``ServingRuntime`` builds it, from a configuration file's fields.

This module and ``trace.py`` are the only ones that import the program.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterable

import torch

from . import traffic
from .weights import dims, llama_weights, snac_weights


BUILD_DIRS = [Path(__file__).resolve().parents[2] / "project_morpheus_tpu_torch" / sub / "_build"
              for sub in ("ops", "native")]


def built_libraries() -> int:
    """Libraries the port has built in this checkout so far (none before
    its first run: that run's set-up compiles them)."""
    return sum(len(list(d.glob("*.so"))) for d in BUILD_DIRS if d.is_dir())


def llama_config(conf: Dict):
    from project_morpheus_tpu_torch.model.config import LlamaConfig

    d = dims(conf)
    return LlamaConfig(vocab_size=d["V"], hidden_size=d["D"], intermediate_size=d["F"],
                       num_layers=d["L"], num_heads=d["H"], num_kv_heads=d["KV"],
                       head_dim=d["HD"], max_seq_len=conf["engine"]["max_seq_len"],
                       rope_theta=d["theta"], rope_scaling_factor=1.0, rms_eps=d["eps"],
                       tie_embeddings=d["tied"], dtype=conf["engine"]["dtype"])


def snac_config(codec: Dict):
    from project_morpheus_tpu_torch.codec.snac_config import SNACConfig

    return SNACConfig(decoder_dim=codec["decoder_dim"],
                      decoder_rates=tuple(codec["decoder_rates"]),
                      codebook_size=codec["codebook_size"], codebook_dim=codec["codebook_dim"],
                      vq_strides=tuple(codec["vq_strides"]), latent_dim=codec["latent"],
                      depthwise=True, noise=True)


def build_engine(conf: Dict, seed: int, device: str):
    """The engine over this seed's weights: bf16 weights made on the
    device, ``quantize_params_int8``, ``EngineConfig`` from the file's
    ``engine`` fields, ``OrpheusEngine`` with the SNAC codec."""
    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
    from project_morpheus_tpu_torch.model.quant import quantize_params_int8

    e = conf["engine"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[e["dtype"]]
    params = llama_weights(conf, seed, device, dtype)
    if e["quant"] == "int8":
        params = quantize_params_int8(params)
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    ecfg = EngineConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in e.items() if k in fields})
    codec = (snac_weights(conf["codec"], seed, device), snac_config(conf["codec"]))
    engine = OrpheusEngine(params, llama_config(conf), ecfg, codec=codec, device=device)
    del params
    return engine


def warm_lengths(mix: Dict, items: Iterable) -> list:
    """Prompt lengths whose prefill programs and frame buckets cover this
    run: the run's own lengths (each length's chunk plan and buckets) and
    the mix's extremes."""
    lo, hi = traffic.prompt_range(mix)
    return sorted({lo, hi, *(len(i.prompt) for i in items)})


def warmup(engine, mix: Dict, items) -> int:
    """``engine.warmup`` for this run's shapes (every prefill round at
    widths up to the mix's burst, every frame program their streams
    cross); returns the programs exercised."""
    lens = warm_lengths(mix, items)
    return engine.warmup(lens, traffic.longest_output_tokens(mix),
                         burst=int(mix["warmup_burst"]))


def sampling(mix: Dict, item):
    from project_morpheus_tpu_torch.model.sampling import SamplingParams

    s = mix["sampling"]
    return SamplingParams(temperature=0.0 if item.greedy else s["temperature"],
                          top_p=s["top_p"], repetition_penalty=s["repetition_penalty"],
                          max_tokens=item.max_tokens, seed=item.seed)
