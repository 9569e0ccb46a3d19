"""Prompt formatting and tokenization for the Orpheus decoder (port of
model/tokenizer.py).

The reference formats prompts as ``<start> "{voice}: {text}" <eot><end...>``
(inference.py:209-223, engine_class.py:87-101) through a HF/llama tokenizer.
Here the prompt contract is expressed in **token-id space** via
:func:`format_prompt_ids`; the text tokenizer is pluggable:

- ``BPETokenizer`` reads a local HF ``tokenizer.json`` (byte-level BPE, as
  Llama-3 and Orpheus ship it) with no ``transformers``: the port's
  counterpart of the JAX package's ``HFTokenizer``.  Path via
  ``ORPHEUS_TOKENIZER_PATH``; a path that cannot be loaded raises.
- ``ByteTokenizer`` is used when no path is set: UTF-8 bytes offset into
  the ASCII-ish id range.  With random weights it exercises the identical
  engine/prompt machinery, mirroring the reference's stubbed-tokenizer
  test strategy (SURVEY.md §4).
"""
from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import regex

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


# --------------------------------------------------------- byte-level BPE

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map of the ByteLevel stages."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHARS = _bytes_to_unicode()
_CHAR_BYTES = {c: b for b, c in _BYTE_CHARS.items()}

_CLEANUPS = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


class _Trie:
    """Leftmost-longest matching of added tokens, as the AddedVocabulary
    of HF ``tokenizers`` matches them."""

    def __init__(self, tokens: Dict[str, dict]) -> None:
        self.root: dict = {}
        for content, tok in tokens.items():
            node = self.root
            for ch in content:
                node = node.setdefault(ch, {})
            node[None] = tok

    def split(self, text: str) -> List[Tuple[str, Optional[dict]]]:
        """[(segment, None) | (token text, token)] covering ``text``."""
        out: List[Tuple[str, Optional[dict]]] = []
        start = i = 0
        while i < len(text):
            node, j, hit = self.root, i, None
            while j < len(text) and text[j] in node:
                node = node[text[j]]
                j += 1
                if None in node:
                    hit = (j, node[None])
            if hit is None:
                i += 1
                continue
            end, tok = hit
            if i > start:
                out.append((text[start:i], None))
            out.append((text[i:end], tok))
            start = i = end
        if start < len(text):
            out.append((text[start:], None))
        return out


class BPETokenizer:
    """Byte-level BPE from a local HF ``tokenizer.json`` (no
    ``transformers``): the port's counterpart of ``HFTokenizer``.

    ``encode`` is ``AutoTokenizer.encode(text, add_special_tokens=False)``:
    added and special tokens are matched first (leftmost-longest; the ones
    not ``normalized``, then the rest), each remaining segment is split by
    the pre-tokenizer's ``Split`` patterns read from the file, byte-mapped,
    and merged by rank (a piece already in the vocabulary is kept whole
    when the model sets ``ignore_merges``); no BOS, no post-processor.
    ``decode`` is ``AutoTokenizer.decode(ids)``: every token, added ones
    too, through the ByteLevel decoder, then the
    ``clean_up_tokenization_spaces`` replacements when
    ``tokenizer_config.json`` sets them.  A file that uses a normalizer or a
    model, pre-tokenizer or decoder this class does not implement raises."""

    def __init__(self, path) -> None:
        p = Path(os.path.expanduser(str(path)))
        file = p / "tokenizer.json" if p.is_dir() else p
        spec = json.loads(file.read_text(encoding="utf-8"))
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"{file}: model type {model.get('type')!r}, only 'BPE' is read")
        for key in ("byte_fallback", "continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if model.get(key):
                raise ValueError(f"{file}: BPE option {key}={model[key]!r} is not implemented")
        if spec.get("normalizer") is not None:
            raise ValueError(f"{file}: normalizers are not implemented")
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            raise ValueError(f"{file}: decoder {decoder.get('type')!r}, only 'ByteLevel' is read")
        self._splits = self._read_pre_tokenizer(file, spec.get("pre_tokenizer") or {})
        self.vocab: Dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        self._ranks = {pair: r for r, pair in enumerate(merges)}
        self._ignore_merges = bool(model.get("ignore_merges", False))
        added = {t["content"]: t for t in spec.get("added_tokens", [])}
        for key in ("single_word", "lstrip", "rstrip"):
            if any(t.get(key) for t in added.values()):
                raise ValueError(f"{file}: {key} added tokens are not implemented")
        self._tries = [_Trie({c: t for c, t in added.items() if not t.get("normalized")}),
                       _Trie({c: t for c, t in added.items() if t.get("normalized")})]
        self._id_to_token = {i: tok for tok, i in self.vocab.items()}
        self._id_to_token.update({t["id"]: c for c, t in added.items()})
        self._cache: Dict[str, List[int]] = {}
        cfg_file = file.parent / "tokenizer_config.json"
        tcfg = json.loads(cfg_file.read_text(encoding="utf-8")) if cfg_file.exists() else {}
        self._clean_up = bool(tcfg.get("clean_up_tokenization_spaces", False))

    @staticmethod
    def _read_pre_tokenizer(file: Path, pre: dict) -> List[regex.Pattern]:
        """The split patterns, in order, of a ``Split``... ``ByteLevel``
        pre-tokenizer (``ByteLevel`` last, without its own split, as in
        the Llama-3 file)."""
        steps = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" else [pre]
        if not steps or steps[-1].get("type") != "ByteLevel":
            raise ValueError(f"{file}: pre-tokenizer must end in ByteLevel, got {pre!r}")
        splits = []
        for step in steps[:-1]:
            if (step.get("type") != "Split" or step.get("behavior") != "Isolated"
                    or step.get("invert")):
                raise ValueError(f"{file}: pre-tokenizer step {step!r} is not implemented")
            pat = step["pattern"]
            splits.append(regex.compile(pat["Regex"] if "Regex" in pat
                                        else regex.escape(pat["String"])))
        if steps[-1].get("add_prefix_space") or steps[-1].get("use_regex", True):
            raise ValueError(f"{file}: ByteLevel add_prefix_space / use_regex are not implemented")
        return splits

    # ------------------------------------------------------------ encode

    def _pieces(self, text: str) -> List[str]:
        pieces = [text]
        for pat in self._splits:
            nxt = []
            for piece in pieces:
                at = 0
                for m in pat.finditer(piece):
                    if m.start() > at:
                        nxt.append(piece[at:m.start()])
                    if m.end() > m.start():
                        nxt.append(m.group())
                    at = m.end()
                if at < len(piece):
                    nxt.append(piece[at:])
            pieces = nxt
        return pieces

    def _bpe(self, word: str) -> List[int]:
        if self._ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms = list(word)
        while len(syms) > 1:
            ranked = [(self._ranks[pair], i) for i, pair in enumerate(zip(syms, syms[1:]))
                      if pair in self._ranks]
            if not ranked:
                break
            i = min(ranked)[1]
            best = (syms[i], syms[i + 1])
            merged, i = [], 0
            while i < len(syms):
                if i + 1 < len(syms) and (syms[i], syms[i + 1]) == best:
                    merged.append(syms[i] + syms[i + 1])
                    i += 2
                else:
                    merged.append(syms[i])
                    i += 1
            syms = merged
        try:
            return [self.vocab[s] for s in syms]
        except KeyError as e:
            raise ValueError(f"symbol {e.args[0]!r} is not in the vocabulary") from None

    def _encode_segment(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._pieces(text):
            word = "".join(_BYTE_CHARS[b] for b in piece.encode("utf-8"))
            if word not in self._cache:
                if len(self._cache) >= 65536:
                    self._cache.clear()
                self._cache[word] = self._bpe(word)
            ids += self._cache[word]
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for seg, tok in self._tries[0].split(text):
            if tok is not None:
                ids.append(tok["id"])
                continue
            for sub, tok2 in self._tries[1].split(seg):
                ids += [tok2["id"]] if tok2 is not None else self._encode_segment(sub)
        return ids

    # ------------------------------------------------------------ decode

    def decode(self, ids: Sequence[int]) -> str:
        data = bytearray()
        for i in ids:
            t = self._id_to_token.get(int(i))
            if t is None:
                continue
            if all(c in _CHAR_BYTES for c in t):
                data += bytes(_CHAR_BYTES[c] for c in t)
            else:  # the ByteLevel decoder passes such a token through as text
                data += t.encode("utf-8")
        text = data.decode("utf-8", errors="replace")
        if self._clean_up:
            for a, b in _CLEANUPS:
                text = text.replace(a, b)
        return text


# the JAX package's name for its local HF tokenizer
HFTokenizer = BPETokenizer


@functools.lru_cache(maxsize=4)
def load_tokenizer(path: str) -> BPETokenizer:
    """The ``BPETokenizer`` of a directory holding ``tokenizer.json`` (or
    of the file itself), read once per path; raises, naming the path and
    the reason, when it cannot be read."""
    try:
        return BPETokenizer(path)
    except (OSError, ValueError, KeyError, TypeError, regex.error) as e:
        raise RuntimeError(f"ORPHEUS_TOKENIZER_PATH={path!r} cannot be loaded: "
                           f"{type(e).__name__}: {e}") from e


def default_tokenizer() -> TextTokenizer:
    """``load_tokenizer(ORPHEUS_TOKENIZER_PATH)`` when the variable is set
    (an unreadable path raises); ``ByteTokenizer`` when it is not."""
    path = os.environ.get("ORPHEUS_TOKENIZER_PATH")
    if not path:
        return ByteTokenizer()
    return load_tokenizer(path)


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
