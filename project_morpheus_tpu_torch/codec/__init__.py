"""SNAC codec: audio-token frames -> 24 kHz PCM (decoder, the exact stream
decoder, and the windowed and parity stream decoders)."""

from .frames import FRAME_TOKENS, codes_to_tokens, tokens_to_codes
from .snac_config import SNACConfig

__all__ = ["SNACConfig", "FRAME_TOKENS", "tokens_to_codes", "codes_to_tokens"]
