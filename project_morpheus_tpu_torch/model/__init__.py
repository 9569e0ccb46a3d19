"""Orpheus decoder model: Llama-3.2-class transformer for serving and
training, int8 weights, sampling and tokenizers."""

from .config import ORPHEUS_SPECIAL_TOKENS, LlamaConfig
from .llama import (
    init_kv_cache,
    init_llama_params,
    llama_decode_step,
    llama_forward,
    llama_prefill_chunk,
    llama_prefill_chunk_batch,
)
from .sampling import SamplingParams, init_sampler_state, sample_logits
from .tokenizer import ByteTokenizer, HFTokenizer, format_prompt_ids

__all__ = [
    "LlamaConfig",
    "ORPHEUS_SPECIAL_TOKENS",
    "init_llama_params",
    "llama_forward",
    "llama_decode_step",
    "llama_prefill_chunk",
    "llama_prefill_chunk_batch",
    "init_kv_cache",
    "SamplingParams",
    "sample_logits",
    "init_sampler_state",
    "ByteTokenizer",
    "HFTokenizer",
    "format_prompt_ids",
]
