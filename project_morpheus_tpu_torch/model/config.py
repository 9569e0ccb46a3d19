"""Model configuration for the Orpheus (Llama-3.2-class) decoder.

Token-space contract (reference SURVEY.md §2.2):
- Llama-3.2 text vocab: 128,256 ids (0..128255), special ids 128000+.
- Orpheus adds 28,682 ``<custom_token_i>`` ids appended in order, so
  ``<custom_token_N>`` has token id ``128256 + N``
  (Orpheus-TTS/pretrain/train.py:173-176).
- Audio codes decode as ``code = N - 10 - (pos%7)*4096`` — i.e. in token-id
  space ``code = id - 128266 - (pos%7)*4096``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LLAMA3_TEXT_VOCAB = 128_256
ORPHEUS_EXTRA_TOKENS = 28_682  # 7 * 4096 + 10
ORPHEUS_VOCAB = LLAMA3_TEXT_VOCAB + ORPHEUS_EXTRA_TOKENS  # 156,938

# Special token ids (reference inference.py:166-167, engine_class.py:87-101,
# realtime_streaming_example/main.py:43, pretrain/train.py:140-162).
ORPHEUS_SPECIAL_TOKENS = {
    "start_of_human": 128259,        # prepended before the prompt
    "end_of_text": 128009,           # <|eot_id|>
    "end_of_human": 128260,
    "start_of_ai": 128261,
    "start_of_speech": 128257,       # model begins audio tokens after this
    "end_of_speech": 128258,         # production stop token
    "pad": 128263,                   # pad id used by the pretrain collator
    "stop_alt": 49158,               # legacy stop id in the pypi engine
    "audio_base": 128256 + 10,       # first audio code id (custom_token_10)
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = ORPHEUS_VOCAB
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192          # reference n_ctx (llama_local.py:45-46)
    rope_theta: float = 500_000.0
    rope_scaling_factor: float = 32.0     # llama-3.2 long-rope scaling
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a lane multiple so the lm_head matmul tiles the MXU."""
        return _round_up(self.vocab_size, 256)

    @classmethod
    def orpheus_3b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def orpheus_1b(cls) -> "LlamaConfig":
        """Llama-3.2-1B-shaped variant (useful on small HBM budgets)."""
        return cls(
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
        )

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Hermetic test config: same topology, small dims, full token space."""
        return cls(
            vocab_size=ORPHEUS_VOCAB,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_seq_len=512,
            rope_scaling_factor=1.0,
        )

    @classmethod
    def tiny_vocab(cls) -> "LlamaConfig":
        """Even smaller: reduced vocab for fast CPU sampling tests."""
        return cls(
            vocab_size=1024,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_seq_len=256,
            rope_scaling_factor=1.0,
        )
