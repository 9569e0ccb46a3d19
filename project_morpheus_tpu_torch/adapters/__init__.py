"""TTS adapter registry and the in-process backend (``local_torch``)."""

from .registry import AdapterRegistry, VoiceSchema, registry

__all__ = ["AdapterRegistry", "VoiceSchema", "registry"]
