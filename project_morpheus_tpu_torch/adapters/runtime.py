"""Shared serving runtime: model + engine + codec, built lazily from env
configuration (port of adapters/runtime.py):

- ``ORPHEUS_ENGINE_MODE``: ``torch`` (default) | ``mock``: mock emits
  well-formed audio-band tokens without a model (the hermetic test/demo
  backend).
- ``ORPHEUS_MODEL_SIZE``: ``tiny`` | ``1b`` | ``3b`` (default tiny): the
  random-weight model, and the dtype of loaded weights (fp32 for tiny on
  the CPU, bf16 otherwise).
- ``ORPHEUS_CHECKPOINT_PATH``: an HF release directory (``config.json``
  and safetensors or ``pytorch_model*.bin`` shards), loaded by
  ``model/hf_weights.py``, or a directory the port's
  ``training.checkpoint.save_params`` wrote (``llama_config.json`` beside
  it sets the architecture); unset -> random weights.  An orbax directory
  of the JAX package raises.
- ``ORPHEUS_SNAC_PATH``: ``.npz`` of torch-layout SNAC state (write one
  with ``tools/convert_snac.py``); unset -> random SNAC weights.
- ``ORPHEUS_TOKENIZER_PATH``: read by ``model/tokenizer.default_tokenizer``.
- ``ORPHEUS_QUANT=int8``: int8 weight-only quantization.
- ``ORPHEUS_KV_QUANT``: KV cache dtype, ``bfloat16`` (default) or ``int8``.
- ``ORPHEUS_MAX_SLOTS`` / ``ORPHEUS_MAX_SEQ``: engine geometry (the KV
  cache is sized by ``ORPHEUS_MAX_SEQ``, never by the checkpoint's
  ``max_position_embeddings``).

Random weights are drawn on the device from a seeded generator; the random
SNAC weights come from the same seeded numpy state as the JAX runtime's.
A path that is set but cannot be read raises; nothing falls back to random
weights.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..model.config import LlamaConfig, ORPHEUS_SPECIAL_TOKENS
from ..model.sampling import SamplingParams
from ..utils.device import resolve_device

AUDIO_BASE = ORPHEUS_SPECIAL_TOKENS["audio_base"]
CODEBOOK = 4096
SAMPLE_RATE = 24_000


class MockEngine:
    """Engine stand-in emitting valid audio-band token ids.

    Deterministic per prompt; ~82 tokens/s of audio content with zero
    compute, so orchestrator/server behaviour is testable hermetically.
    """

    def __init__(self, tokens_per_request: int = 7 * 24) -> None:
        self.tokens_per_request = tokens_per_request
        self._tasks: set = set()

    async def submit(self, prompt_ids, sampling: Optional[SamplingParams] = None):
        from ..engine.request import Request, RequestState

        sampling = sampling or SamplingParams()
        req = Request(list(prompt_ids), sampling)
        req.state = RequestState.DECODING
        total = min(self.tokens_per_request, sampling.max_tokens)
        seed = (sum(prompt_ids) + len(prompt_ids)) % (2**31)
        rng = np.random.default_rng(seed)

        async def fill():
            for pos in range(total):
                code = int(rng.integers(0, CODEBOOK))
                req.token_queue.put_nowait(AUDIO_BASE + code + (pos % 7) * CODEBOOK)
                if pos % 21 == 20:
                    await asyncio.sleep(0)  # yield to the loop
            req.state = RequestState.FINISHED
            req.token_queue.put_nowait(None)

        task = asyncio.get_running_loop().create_task(fill())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return req

    def cancel(self, req) -> None:
        from ..engine.request import RequestState

        if not req.done:
            req.state = RequestState.CANCELLED
            req.token_queue.put_nowait(None)

    async def close(self) -> None:
        for task in list(self._tasks):
            task.cancel()


class ServingRuntime:
    """Lazily constructed model/engine/codec bundle on one device.

    ``num_layers`` cuts the random model's depth (widths stay);
    ``engine_kw`` overrides :class:`EngineConfig` fields."""

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

    @property
    def mode(self) -> str:
        return os.environ.get("ORPHEUS_ENGINE_MODE", "torch")

    async def ensure(self) -> "ServingRuntime":
        async with self._lock:
            if self.engine is None:
                self.build()
            return self

    def _build_codec(self, size: str) -> None:
        from ..codec.snac_config import SNACConfig
        from ..codec.weights import init_snac_params, params_from_torch_state, to_torch

        snac_path = os.environ.get("ORPHEUS_SNAC_PATH")
        if size == "tiny" and not snac_path:
            self.snac_cfg = SNACConfig.tiny()
        else:
            self.snac_cfg = SNACConfig.snac_24khz()
        if snac_path:
            if not os.path.isfile(snac_path):
                raise FileNotFoundError(f"ORPHEUS_SNAC_PATH={snac_path!r} is not a file")
            with np.load(snac_path) as npz:
                state = dict(npz)
            self.snac_params = to_torch(params_from_torch_state(state, self.snac_cfg),
                                        self.device)
        else:
            self.snac_params = init_snac_params(self.snac_cfg, seed=0, device=self.device)

    def load_params(self) -> Tuple[dict, LlamaConfig]:
        """The model's (params, config) before quantization: the HF
        directory at ``ORPHEUS_CHECKPOINT_PATH``, or random weights of
        ``ORPHEUS_MODEL_SIZE``."""
        import torch

        from ..model.llama import init_llama_params

        size = os.environ.get("ORPHEUS_MODEL_SIZE", "tiny")
        cfg = {"tiny": LlamaConfig.tiny, "1b": LlamaConfig.orpheus_1b,
               "3b": LlamaConfig.orpheus_3b}[size]()
        # on the card every size runs in bf16, the activation dtype the
        # CUDA kernels take
        on_cpu = self.device.type == "cpu"
        dtype = torch.float32 if size == "tiny" and on_cpu else torch.bfloat16
        ckpt = os.environ.get("ORPHEUS_CHECKPOINT_PATH")
        if not ckpt:
            if self.num_layers is not None:
                cfg = dataclasses.replace(cfg, num_layers=self.num_layers)
            return init_llama_params(cfg, 0, self.device, dtype), cfg
        d = Path(os.path.expanduser(ckpt))
        if not d.is_dir():
            raise FileNotFoundError(f"ORPHEUS_CHECKPOINT_PATH={ckpt!r} is not a directory")
        if any(d.glob("*.safetensors")) or any(d.glob("pytorch_model*.bin")):
            from ..model.hf_weights import load_hf_checkpoint

            return load_hf_checkpoint(d, None if (d / "config.json").exists() else cfg,
                                      dtype=dtype, device=self.device)
        from ..training.checkpoint import find_params, restore_params
        from ..model.bridge import tree_map

        if find_params(d) is None:
            raise NotImplementedError(
                f"ORPHEUS_CHECKPOINT_PATH={ckpt!r} is neither an HF directory (*.safetensors, "
                "pytorch_model*.bin) nor a checkpoint of the port's trainer "
                "(step_N/ or latest/ with params.safetensors): orbax checkpoints of the JAX "
                "package are not read (orbax is not installed where the port runs); write "
                "one with project_morpheus_tpu_torch.training.checkpoint.save_params")
        # the trainer's own checkpoint; llama_config.json beside it, where
        # save_params wrote one, sets the architecture; leaves take the
        # runtime's dtype, as an HF directory's do
        cfg_json = d / "llama_config.json"
        if cfg_json.exists():
            cfg = LlamaConfig(**json.loads(cfg_json.read_text()))
        params = restore_params(d, device=self.device)
        return tree_map(lambda t: t.to(dtype), params), cfg

    def build(self, loaded: Optional[Tuple[dict, LlamaConfig]] = None) -> None:
        """Build the codec and the engine; ``loaded`` is ``load_params()``'s
        result, which is called when it is not given."""
        from ..engine import EngineConfig, OrpheusEngine
        from ..model.quant import quantize_params_int8

        size = os.environ.get("ORPHEUS_MODEL_SIZE", "tiny")
        self._build_codec(size)
        if self.mode == "mock":
            self.engine = MockEngine()
            return
        params, cfg = loaded if loaded is not None else self.load_params()
        self.model_cfg = cfg
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
