"""Adapter registry: name -> (constructor, capability descriptor, voice map)
(port of adapters/registry.py).

Functional parity with reference tts_engine/adapter_registry.py:22-107.
The descriptor schema is the stable surface the admin UI and /adapters
endpoint expose: ``{name, streaming, unit, granularity, voices,
supports_barge_in, supports_seed, stateful_context}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from pydantic import BaseModel

from ..model.tokenizer import AVAILABLE_VOICES, DEFAULT_VOICE
from ..orchestrator.chunk_ladder import DEFAULT_LADDER


class VoiceSchema(BaseModel):
    """Backend-agnostic voice description (reference adapter_registry.py:22-37)."""

    voice: Optional[str] = None
    timbre: Optional[str] = None
    prosody: Optional[str] = None
    accent: Optional[str] = None
    emotion_priors: Optional[str] = None
    pace: Optional[str] = None


def flat_voices() -> List[str]:
    return [v for vs in AVAILABLE_VOICES.values() for v in vs]


def orpheus_voice_mapper(schema: VoiceSchema) -> Dict[str, Any]:
    voice = schema.voice or schema.timbre or DEFAULT_VOICE
    if voice not in flat_voices():
        voice = DEFAULT_VOICE
    return {"voice": voice}


@dataclass
class _AdapterSpec:
    constructor: Callable[..., Any]
    describe: Callable[[], Dict[str, Any]]
    voice_mapper: Callable[[VoiceSchema], Dict[str, Any]]


class AdapterRegistry:
    def __init__(self) -> None:
        self._specs: Dict[str, _AdapterSpec] = {}

    def register(
        self,
        name: str,
        constructor: Callable[..., Any],
        describe: Callable[[], Dict[str, Any]],
        voice_mapper: Callable[[VoiceSchema], Dict[str, Any]] = orpheus_voice_mapper,
    ) -> None:
        self._specs[name] = _AdapterSpec(constructor, describe, voice_mapper)

    def names(self) -> List[str]:
        return list(self._specs)

    def available(self) -> Dict[str, Dict[str, Any]]:
        return {name: spec.describe() for name, spec in self._specs.items()}

    def create(self, name: str, *, prompt: str, voice: VoiceSchema, **kwargs: Any):
        spec = self._specs[name]
        params = spec.voice_mapper(voice)
        params.update(kwargs)
        return spec.constructor(prompt=prompt, **params)


def _local_describe() -> Dict[str, Any]:
    return {
        "name": "local_torch",
        "streaming": True,
        "unit": "bytes",
        "granularity": list(DEFAULT_LADDER),
        "voices": AVAILABLE_VOICES,
        "supports_barge_in": True,
        "supports_seed": True,
        "stateful_context": "kv-slot",
    }


def _remote_describe() -> Dict[str, Any]:
    return {
        "name": "remote_sse",
        "streaming": True,
        "unit": "bytes",
        "granularity": list(DEFAULT_LADDER),
        "voices": AVAILABLE_VOICES,
        "supports_barge_in": True,
        "supports_seed": False,
        "stateful_context": "none",
    }


registry = AdapterRegistry()


def _register_bundled() -> None:
    from .local_torch import LocalTorchAdapter
    from .remote_backend import RemoteSSEAdapter

    registry.register("local_torch", LocalTorchAdapter, _local_describe)
    registry.register("remote_sse", RemoteSSEAdapter, _remote_describe)


_register_bundled()
