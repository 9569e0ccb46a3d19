"""Compatibility facades for users migrating from the reference stack."""

from .orpheus_tts import OrpheusModel

__all__ = ["OrpheusModel"]
