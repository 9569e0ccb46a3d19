"""The system under test: ``project_morpheus_tpu_torch``'s engine, built
as its ``ServingRuntime`` builds it, from a configuration file's fields
and its decoder family's inputs (``families/<family>/``).

This module, ``trace.py`` and each family's ``program.py`` are the only
ones that import the program.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterable

import torch

from . import spec, traffic
from .weights import snac_weights


BUILD_DIRS = [Path(__file__).resolve().parents[2] / "project_morpheus_tpu_torch" / sub / "_build"
              for sub in ("ops", "native")]


def built_libraries() -> int:
    """Libraries the port has built in this checkout so far (none before
    its first run: that run's set-up compiles them)."""
    return sum(len(list(d.glob("*.so"))) for d in BUILD_DIRS if d.is_dir())


def snac_config(codec: Dict):
    from project_morpheus_tpu_torch.codec.snac_config import SNACConfig

    return SNACConfig(decoder_dim=codec["decoder_dim"],
                      decoder_rates=tuple(codec["decoder_rates"]),
                      codebook_size=codec["codebook_size"], codebook_dim=codec["codebook_dim"],
                      vq_strides=tuple(codec["vq_strides"]), latent_dim=codec["latent"],
                      depthwise=True, noise=True)


def build_engine(conf: Dict, seed: int, device: str):
    """The engine over this seed's weights: the family's weights made on
    the device in the served dtype, handed to the engine as the family's
    ``engine_inputs`` gives them, ``EngineConfig`` from the file's
    ``engine`` fields, ``OrpheusEngine`` with the SNAC codec."""
    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine

    e = conf["engine"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[e["dtype"]]
    family = spec.family(conf)
    params, model_config = family.program.engine_inputs(
        conf, family.weights.weights(conf, seed, device, dtype))
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    ecfg = EngineConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in e.items() if k in fields})
    codec = (snac_weights(conf["codec"], seed, device), snac_config(conf["codec"]))
    engine = OrpheusEngine(params, model_config, ecfg, codec=codec, device=device)
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
