"""TTS adapter registry and backends: ``local_torch`` (the in-process
engine) and ``remote_sse`` (OpenAI-compatible SSE token stream, decoded
here by the exact SNAC stream decoder)."""

from .registry import AdapterRegistry, VoiceSchema, registry

__all__ = ["AdapterRegistry", "VoiceSchema", "registry"]
