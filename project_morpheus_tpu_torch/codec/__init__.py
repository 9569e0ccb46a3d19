"""SNAC codec: audio-token frames -> 24 kHz PCM (decoder and encoder, the
exact stream decoder, and the windowed and parity stream decoders with
their batched window decode)."""

from .frames import (
    FRAME_TOKENS,
    audio_code_from_custom_number,
    codes_to_tokens,
    parse_custom_token,
    tokens_to_codes,
)
from .snac import snac_decode, snac_encode
from .snac_config import SNACConfig
from .stream_decode import (
    ExactStreamDecoder,
    StreamPlanner,
    init_stream_state,
    make_stream_decoder,
    reset_lanes,
    snac_stream_step,
)
from .streaming import HOP_SAMPLES, StreamingSnacDecoder, decode_windows_batched
from .weights import init_snac_params

__all__ = [
    "ExactStreamDecoder",
    "make_stream_decoder",
    "StreamPlanner",
    "init_stream_state",
    "reset_lanes",
    "snac_stream_step",
    "SNACConfig",
    "FRAME_TOKENS",
    "tokens_to_codes",
    "codes_to_tokens",
    "audio_code_from_custom_number",
    "parse_custom_token",
    "snac_decode",
    "snac_encode",
    "init_snac_params",
    "StreamingSnacDecoder",
    "HOP_SAMPLES",
    "decode_windows_batched",
]
