"""Shared serving runtime: model + engine + codec, built lazily from env
configuration (port of adapters/runtime.py):

- ``ORPHEUS_MODEL_SIZE``: ``tiny`` | ``1b`` | ``3b`` (default tiny).
- ``ORPHEUS_QUANT=int8``: int8 weight-only quantization.
- ``ORPHEUS_KV_QUANT``: KV cache dtype, ``bfloat16`` (default) or ``int8``.
- ``ORPHEUS_MAX_SLOTS`` / ``ORPHEUS_MAX_SEQ``: engine geometry.

Weights are random, drawn on the device from a seeded generator (tiny in
fp32 on the CPU, everything else in bf16); the SNAC weights come from the same seeded numpy
state as the JAX runtime's.  Checkpoint loading is not ported yet.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
from typing import Optional

from ..model.config import LlamaConfig, ORPHEUS_SPECIAL_TOKENS
from ..utils.device import resolve_device

AUDIO_BASE = ORPHEUS_SPECIAL_TOKENS["audio_base"]
CODEBOOK = 4096
SAMPLE_RATE = 24_000


class ServingRuntime:
    """Lazily constructed model/engine/codec bundle on one device.

    ``num_layers`` cuts the model's depth (widths stay); ``engine_kw``
    overrides :class:`EngineConfig` fields."""

    def __init__(self, device="cuda", *, num_layers: Optional[int] = None,
                 **engine_kw) -> None:
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.engine_kw = engine_kw
        self._lock = asyncio.Lock()
        self.engine = None
        self.snac_params = None
        self.snac_cfg = None
        self.model_cfg: Optional[LlamaConfig] = None

    async def ensure(self) -> "ServingRuntime":
        async with self._lock:
            if self.engine is None:
                self.build()
            return self

    def build(self) -> None:
        import torch

        from ..codec.snac_config import SNACConfig
        from ..codec.weights import init_snac_params
        from ..engine import EngineConfig, OrpheusEngine
        from ..model.llama import init_llama_params
        from ..model.quant import quantize_params_int8

        if os.environ.get("ORPHEUS_CHECKPOINT_PATH") or os.environ.get("ORPHEUS_SNAC_PATH"):
            raise NotImplementedError(
                "checkpoint loading is not ported yet; unset ORPHEUS_CHECKPOINT_PATH "
                "and ORPHEUS_SNAC_PATH to serve random weights")
        size = os.environ.get("ORPHEUS_MODEL_SIZE", "tiny")
        self.snac_cfg = SNACConfig.tiny() if size == "tiny" else SNACConfig.snac_24khz()
        self.snac_params = init_snac_params(self.snac_cfg, seed=0, device=self.device)
        cfg = {"tiny": LlamaConfig.tiny, "1b": LlamaConfig.orpheus_1b,
               "3b": LlamaConfig.orpheus_3b}[size]()
        if self.num_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=self.num_layers)
        self.model_cfg = cfg
        # on the card every size runs in bf16, the activation dtype the
        # CUDA kernels take
        on_cpu = self.device.type == "cpu"
        dtype = torch.float32 if size == "tiny" and on_cpu else torch.bfloat16
        params = init_llama_params(cfg, 0, self.device, dtype)
        if os.environ.get("ORPHEUS_QUANT", "").lower() == "int8":
            params = quantize_params_int8(params)
        default_seq = "2048" if size == "tiny" else "8192"
        kv_dtype = os.environ.get("ORPHEUS_KV_QUANT", "bfloat16").lower()
        if kv_dtype in ("", "0", "off", "none"):
            kv_dtype = "bfloat16"
        ecfg = EngineConfig(
            max_slots=int(os.environ.get("ORPHEUS_MAX_SLOTS", "8")),
            max_seq_len=int(os.environ.get("ORPHEUS_MAX_SEQ", default_seq)),
            cache_dtype=kv_dtype,
            **self.engine_kw,
        )
        self.engine = OrpheusEngine(params, cfg, ecfg, codec=(self.snac_params, self.snac_cfg),
                                    device=self.device)

    async def reset(self) -> None:
        """Drop the engine (config hot-swap path)."""
        async with self._lock:
            if self.engine is not None:
                await self.engine.close()
            self.engine = None


_runtime: Optional[ServingRuntime] = None


def get_runtime() -> ServingRuntime:
    """The process-wide runtime (on the card unless ``set_runtime`` chose)."""
    global _runtime
    if _runtime is None:
        _runtime = ServingRuntime()
    return _runtime


def set_runtime(runtime: Optional[ServingRuntime]) -> None:
    global _runtime
    _runtime = runtime


def audio_code_from_token_id(token_id: int, audio_pos: int) -> Optional[int]:
    """Generated token id -> codebook entry, or None if non-audio:
    ``code = id - 128266 - (pos % 7) * 4096``."""
    code = token_id - AUDIO_BASE - (audio_pos % 7) * CODEBOOK
    if 0 <= code < CODEBOOK:
        return code
    return None


def lenient_audio_code(token_id: int) -> Optional[int]:
    """Band-agnostic mapping: any audio-range id -> its in-band code."""
    off = token_id - AUDIO_BASE
    if 0 <= off < 7 * CODEBOOK:
        return off % CODEBOOK
    return None
