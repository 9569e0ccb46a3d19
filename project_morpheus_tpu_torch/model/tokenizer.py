"""Prompt formatting and tokenization for the Orpheus decoder.

The reference formats prompts as ``<start> "{voice}: {text}" <eot><end...>``
(inference.py:209-223, engine_class.py:87-101) through a HF/llama tokenizer.
Here the prompt contract is expressed in **token-id space** via
:func:`format_prompt_ids`; the text tokenizer is pluggable:

- ``HFTokenizer`` wraps a locally available ``transformers`` tokenizer
  (path via ``ORPHEUS_TOKENIZER_PATH``; no network fetch is attempted).
- ``ByteTokenizer`` is the hermetic fallback: UTF-8 bytes offset into the
  ASCII-ish id range.  With random weights it exercises the identical
  engine/prompt machinery, mirroring the reference's stubbed-tokenizer
  test strategy (SURVEY.md §4).
"""
from __future__ import annotations

import os
from typing import List, Optional, Protocol, Sequence

from .config import ORPHEUS_SPECIAL_TOKENS

DEFAULT_VOICE = "tara"  # reference inference.py:125-159

# 24 bundled voices across 8 languages (reference inference.py:125-159).
AVAILABLE_VOICES = {
    "en": ["tara", "leah", "jess", "leo", "dan", "mia", "zac", "zoe"],
    "fr": ["pierre", "amelie", "marie"],
    "de": ["jana", "thomas", "max"],
    "ko": ["유나", "준서"],
    "hi": ["ऋतिका"],
    "zh": ["长乐", "白芷"],
    "es": ["javi", "sergio", "maria"],
    "it": ["pietro", "giulia", "carlo"],
}

# Emotion tags passed through verbatim inside the text (inference.py:376).
EMOTION_TAGS = (
    "<laugh>", "<chuckle>", "<sigh>", "<cough>",
    "<sniffle>", "<groan>", "<yawn>", "<gasp>",
)


class TextTokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """Hermetic UTF-8 byte tokenizer (ids 3..258); id 0 reserved."""

    offset = 3

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(
            max(0, i - self.offset) for i in ids if 0 <= i - self.offset < 256
        ).decode("utf-8", errors="replace")


class HFTokenizer:
    """Wrap a local HuggingFace tokenizer directory (no downloads)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # local import; heavy

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids)


def default_tokenizer() -> TextTokenizer:
    path = os.environ.get("ORPHEUS_TOKENIZER_PATH")
    if path and os.path.isdir(path):
        try:
            return HFTokenizer(path)
        except Exception:
            pass
    return ByteTokenizer()


def format_prompt_ids(
    text: str,
    voice: Optional[str] = DEFAULT_VOICE,
    tokenizer: Optional[TextTokenizer] = None,
) -> List[int]:
    """Build the Orpheus prompt in token-id space.

    Mirrors engine_class.py:87-101: ``[start_of_human] tok("{voice}: {text}")
    [end_of_text, end_of_human, start_of_ai, start_of_speech]``; the model
    is then expected to emit audio tokens until ``end_of_speech``.
    """
    tok = tokenizer or default_tokenizer()
    st = ORPHEUS_SPECIAL_TOKENS
    body = f"{voice}: {text}" if voice else text
    return (
        [st["start_of_human"]]
        + tok.encode(body)
        + [st["end_of_text"], st["end_of_human"], st["start_of_ai"], st["start_of_speech"]]
    )
