"""Orpheus decoder model: Llama-3.2-class transformer for serving."""

from .config import LlamaConfig, ORPHEUS_SPECIAL_TOKENS
from .tokenizer import ByteTokenizer, format_prompt_ids

__all__ = ["LlamaConfig", "ORPHEUS_SPECIAL_TOKENS", "ByteTokenizer", "format_prompt_ids"]
