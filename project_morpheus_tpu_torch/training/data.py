"""Interleaved dual-dataset batching and collation (port of training/data.py).

The Orpheus pretraining recipe interleaves ``ratio`` text-QA batches with
one TTS (audio-token) batch so the decoder keeps its language skills while
learning audio heads (reference pretrain/train.py:40-72).  Rank sharding is
strided and unshuffled (AlternatingDistributedSampler, :76-84) so every
rank stays on the same phase of the text/audio cycle.

Examples are dicts with ``input_ids`` (list[int]); the collator pads to the
longest sequence in the batch (pad id 128263) and masks pad labels to -100
(:140-162).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from ..model.config import ORPHEUS_SPECIAL_TOKENS

PAD_ID = ORPHEUS_SPECIAL_TOKENS["pad"]
IGNORE_LABEL = -100


class BatchedRatioDataset:
    """Yield index batches cycling ``ratio`` text batches then 1 audio batch."""

    def __init__(
        self,
        text_examples: Sequence[dict],
        audio_examples: Sequence[dict],
        batch_size: int,
        ratio: int = 1,
    ) -> None:
        self.text = text_examples
        self.audio = audio_examples
        self.batch_size = batch_size
        self.ratio = ratio

    def __iter__(self) -> Iterator[Dict]:
        ti, ai = 0, 0
        while True:
            for _ in range(self.ratio):
                if ti + self.batch_size > len(self.text):
                    return
                yield {
                    "kind": "text",
                    "examples": list(self.text[ti : ti + self.batch_size]),
                }
                ti += self.batch_size
            if ai + self.batch_size > len(self.audio):
                return
            yield {
                "kind": "audio",
                "examples": list(self.audio[ai : ai + self.batch_size]),
            }
            ai += self.batch_size

    def batches_per_cycle(self) -> int:
        return self.ratio + 1


def shard_for_rank(examples: Sequence[dict], rank: int, world: int) -> List[dict]:
    """Strided, unshuffled rank split (AlternatingDistributedSampler)."""
    return list(examples[rank::world])


def pad_collate(
    examples: Sequence[dict], max_len: int | None = None
) -> Dict[str, np.ndarray]:
    """Pad a batch to its longest sequence (or ``max_len``).

    Returns ``input_ids``, ``attention_mask``, ``labels`` with pad positions
    ignored in the loss.
    """
    seqs = [list(e["input_ids"])[: max_len or None] for e in examples]
    longest = max(len(s) for s in seqs)
    if max_len is not None:
        longest = min(longest, max_len)
    B = len(seqs)
    input_ids = np.full((B, longest), PAD_ID, np.int32)
    attention_mask = np.zeros((B, longest), bool)
    labels = np.full((B, longest), IGNORE_LABEL, np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), longest)
        input_ids[i, :n] = s[:n]
        attention_mask[i, :n] = True
        labels[i, :n] = s[:n]
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
    }
