"""Text chunking utilities.

The reference scales long inputs by application-level chunking, not by
attention-level sequence parallelism (SURVEY.md §5.7): inputs over ~1000
chars are split into sentences and batched (inference.py:249-292,
server.py:180-186).  Short fragments are merged up to a 20-char minimum so
no tiny utterances are synthesised.
"""
from __future__ import annotations

import re
from typing import List

MIN_SENTENCE_CHARS = 20

_SENTENCE_END = re.compile(r"(?<=[.!?])[\s\n\t]+")


def split_text_into_sentences(text: str) -> List[str]:
    """Split on sentence-final punctuation, merging short fragments."""
    parts = [p.strip() for p in _SENTENCE_END.split(text) if p.strip()]
    merged: List[str] = []
    i = 0
    while i < len(parts):
        current = parts[i]
        while i < len(parts) - 1 and len(current) < MIN_SENTENCE_CHARS:
            i += 1
            current += " " + parts[i]
        merged.append(current)
        i += 1
    return merged


def batch_sentences(sentences: List[str], max_batch_chars: int = 1000) -> List[str]:
    """Pack sentences into batches of at most ``max_batch_chars`` each
    (remote_backend.py:221-240 packing semantics)."""
    batches: List[str] = []
    current = ""
    for s in sentences:
        if current and len(current) + 1 + len(s) > max_batch_chars:
            batches.append(current)
            current = s
        else:
            current = f"{current} {s}".strip()
    if current:
        batches.append(current)
    return batches
