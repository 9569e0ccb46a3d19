"""The port's tokenizer against the JAX package's ``HFTokenizer`` (which
wraps ``transformers``) on one ``tokenizer.json``: a byte-level BPE with
the Llama-3 ``Split`` pattern, ``ignore_merges`` and Orpheus-style added
and special tokens, trained here with HF ``tokenizers``.  Token ids and
decoded text must be equal (exact)."""
import json

import pytest

from project_morpheus_tpu.model.tokenizer import HFTokenizer
from project_morpheus_tpu.model.tokenizer import format_prompt_ids as jax_format
from project_morpheus_tpu_torch.model import tokenizer as tk

tokenizers = pytest.importorskip("tokenizers")

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CORPUS = [
    "The quick brown fox jumps over the lazy dog. It's 10:45 and we'll see you're fine.",
    "Café, naïve, façade, jalapeño, crème brûlée — déjà vu!",
    "東京は日本の首都です。我喜欢学习中文。",
    "नमस्ते, आप कैसे हैं? मैं ठीक हूँ।",
    "안녕하세요, 만나서 반갑습니다. 유나와 준서.",
    "1234567890 3.14159 2024-06-01 $100,000",
    "tara: Hello <laugh> there! I can't believe it <sigh>.\nNew line\n\n  spaced   out",
]

TEXTS = [
    "Hello world",
    "tara: Hey there, my name is Tara <chuckle>, and I'm a speech generation model.",
    "Café naïve déjà vu, jalapeño!",
    "東京は日本の首都です。中文测试",
    "नमस्ते दुनिया",
    "유나: 안녕하세요",
    "123456789 and 3.14159, 2024",
    "I've, you'd, they'll, she's, we're, DON'T, I'M",
    "<laugh> <sigh><gasp>then <|eot_id|> and <custom_token_12><custom_token_3>",
    "line one\nline two\r\n\n\nline three",
    "runs   of    spaces\t\ttabs  ",
    "   leading and trailing   ",
    "thequick brown",
    "<ñ> added with an accent, and <custom_token_1> <custom_token_10>",
    "",
    "emoji 🙂 and symbols ©®™ ±",
]


def _train(tmp_path, clean_up: bool):
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=700, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS * 20, trainer)
    tok.add_special_tokens(["<|begin_of_text|>", "<|eot_id|>", "<|audio|>"])
    tok.add_tokens([AddedToken(f"<custom_token_{i}>", normalized=False, special=False)
                    for i in range(64)])
    tok.add_tokens(["<laugh>", "<ñ>"])
    path = tmp_path / "tok"
    path.mkdir()
    tok.save(str(path / "tokenizer.json"))
    spec = json.loads((path / "tokenizer.json").read_text())
    # a whole word that merges would split differently: ignore_merges keeps it
    spec["model"]["ignore_merges"] = True
    n = len(spec["model"]["vocab"])
    spec["model"]["vocab"]["Ġthequick"] = n
    for t in spec["added_tokens"]:
        t["id"] += t["id"] >= n  # ids stay dense, as in a released file
    (path / "tokenizer.json").write_text(json.dumps(spec))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "clean_up_tokenization_spaces": clean_up}))
    return path


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "clean_up"])
def tok_dir(tmp_path_factory, request):
    return _train(tmp_path_factory.mktemp("bpe"), request.param)


def test_encode_decode_match_hf(tok_dir):
    ref, port = HFTokenizer(str(tok_dir)), tk.BPETokenizer(tok_dir)
    assert port.encode(" thequick") == [port.vocab["Ġthequick"]]  # ignore_merges
    for text in TEXTS:
        ids = port.encode(text)
        assert ids == ref.encode(text), text
        assert port.decode(ids) == ref.decode(ids), text
    spec = json.loads((tok_dir / "tokenizer.json").read_text())
    every_id = sorted(spec["model"]["vocab"].values()) + [t["id"] for t in spec["added_tokens"]]
    assert port.decode(every_id) == ref.decode(every_id)


def test_format_prompt_ids_match_hf(tok_dir, monkeypatch):
    monkeypatch.setenv("ORPHEUS_TOKENIZER_PATH", str(tok_dir))
    tk.load_tokenizer.cache_clear()
    for voice in ("tara", "유나", None):
        for text in TEXTS[:4]:
            assert tk.format_prompt_ids(text, voice) == jax_format(text, voice)
    assert isinstance(tk.default_tokenizer(), tk.BPETokenizer)


def test_unreadable_tokenizer_path_raises(tmp_path, monkeypatch):
    """The JAX ``default_tokenizer`` falls back to bytes on any failure;
    the port raises and names the path."""
    tk.load_tokenizer.cache_clear()
    bad = tmp_path / "no_tokenizer_here"
    monkeypatch.setenv("ORPHEUS_TOKENIZER_PATH", str(bad))
    with pytest.raises(RuntimeError, match="no_tokenizer_here"):
        tk.default_tokenizer()
    (tmp_path / "tokenizer.json").write_text('{"model": {"type": "WordPiece"}}')
    monkeypatch.setenv("ORPHEUS_TOKENIZER_PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="WordPiece"):
        tk.default_tokenizer()
    monkeypatch.delenv("ORPHEUS_TOKENIZER_PATH")
    assert isinstance(tk.default_tokenizer(), tk.ByteTokenizer)
