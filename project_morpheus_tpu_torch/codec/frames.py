"""Token-frame math for the Orpheus/SNAC data model.

The LLM emits audio tokens in 7-token frames.  Within a frame, positions
map onto three SNAC codebook levels (coarse/medium/fine) as:

    frame position:   0    1    2    3    4    5    6
    codebook level:   0    1    2    2    1    2    2
    within-level id: c0[0] c1[0] c2[0] c2[1] c1[1] c2[2] c2[3]

i.e. per frame 1 coarse + 2 medium + 4 fine codes (reference layout:
Morpheus_Client/tts_engine/speechpipe.py:84-98).

Token id -> code math (reference speechpipe.py:146-189): audio tokens are
``<custom_token_N>`` strings whose numeric payload encodes the code as

    code = N - 10 - (position_in_frame * 4096)

so each of the 7 frame positions has its own 4096-wide band.  This module
is **id-native**: the serving hot path works directly on integer arrays with
static shapes (jit/vmap-safe); string parsing exists only as an interop
shim for OpenAI-compatible SSE token streams.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FRAME_TOKENS = 7          # tokens per codec frame
CODEBOOK_SIZE = 4096      # codes per SNAC codebook level
CUSTOM_TOKEN_OFFSET = 10  # <custom_token_N>: N = code + 10 + pos*4096

# Within-frame index of each code, per codebook level.
_CB0_POS = (0,)
_CB1_POS = (1, 4)
_CB2_POS = (2, 3, 5, 6)

_CUSTOM_TOKEN_RE = re.compile(r"<custom_token_(\d+)>")


def audio_code_from_custom_number(number: int, position: int) -> int:
    """Map a ``<custom_token_N>`` payload to a codebook entry.

    ``position`` is the running index of the audio token in the stream; only
    ``position % 7`` matters.  Mirrors reference speechpipe.py:181.
    """
    return number - CUSTOM_TOKEN_OFFSET - (position % FRAME_TOKENS) * CODEBOOK_SIZE


def custom_number_from_audio_code(code: int, position: int) -> int:
    """Inverse of :func:`audio_code_from_custom_number`."""
    return code + CUSTOM_TOKEN_OFFSET + (position % FRAME_TOKENS) * CODEBOOK_SIZE


def parse_custom_token(token_string: str, position: int) -> Optional[int]:
    """Interop shim: parse the *last* ``<custom_token_N>`` in ``token_string``.

    Returns the codebook entry, or ``None`` if the string carries no custom
    token (reference speechpipe.py:146-189 incl. the rfind semantics).
    """
    if "<custom_token_" not in token_string:
        return None
    matches = _CUSTOM_TOKEN_RE.findall(token_string.strip())
    if not matches:
        return None
    # Reference uses rfind: take the last token embedded in the string, and
    # requires the string to *end* with it.
    if not token_string.strip().endswith(f"<custom_token_{matches[-1]}>"):
        return None
    return audio_code_from_custom_number(int(matches[-1]), position)


def tokens_to_codes(tokens: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Regroup a flat stream of per-frame codes into the 3 SNAC codebooks.

    Parameters
    ----------
    tokens:
        Integer array of shape ``(..., n_frames * 7)`` holding *codebook
        entries* (already band-unshifted, each in ``[0, 4096)``).

    Returns
    -------
    (codes0, codes1, codes2) with trailing dims ``n, 2n, 4n`` — the coarse,
    medium and fine codebook timelines (reference speechpipe.py:84-98).

    Works on numpy arrays and torch tensors (reshapes, slices and one
    concatenation: no index list, which a captured CUDA graph cannot take).
    """
    n = tokens.shape[-1] // FRAME_TOKENS
    frames = tokens[..., : n * FRAME_TOKENS].reshape(*tokens.shape[:-1], n, FRAME_TOKENS)
    codes0 = frames[..., 0]
    codes1 = frames[..., 1::3].reshape(*tokens.shape[:-1], 2 * n)  # positions 1, 4
    cat = torch.cat if isinstance(tokens, torch.Tensor) else np.concatenate
    codes2 = cat([frames[..., 2:4], frames[..., 5:7]], -1).reshape(*tokens.shape[:-1], 4 * n)
    return codes0, codes1, codes2


def codes_to_tokens(
    codes0: np.ndarray, codes1: np.ndarray, codes2: np.ndarray
) -> np.ndarray:
    """Inverse of :func:`tokens_to_codes`: interleave codebooks into frames."""
    lead = codes0.shape[:-1]
    n = codes0.shape[-1]
    if isinstance(codes0, np.ndarray):
        xp = np
    else:  # torch tensor
        import torch as xp
    frames = xp.stack(
        [
            codes0,
            codes1.reshape(*lead, n, 2)[..., 0],
            codes2.reshape(*lead, n, 4)[..., 0],
            codes2.reshape(*lead, n, 4)[..., 1],
            codes1.reshape(*lead, n, 2)[..., 1],
            codes2.reshape(*lead, n, 4)[..., 2],
            codes2.reshape(*lead, n, 4)[..., 3],
        ],
        -1,
    )
    return frames.reshape(*lead, n * FRAME_TOKENS)


def codes_valid(tokens: Sequence[int]) -> bool:
    """Range check mirroring reference speechpipe.py:108-111.

    The reference accepts ``0 <= code <= 4096`` (inclusive upper bound — an
    off-by-one kept for parity; real codes are < 4096)."""
    arr = np.asarray(tokens)
    return bool(np.all(arr >= 0) and np.all(arr <= CODEBOOK_SIZE))
