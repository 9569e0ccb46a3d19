"""The port's HF checkpoint loader (project_morpheus_tpu_torch.model.hf_weights)
against the JAX package's, on directories written here by ``transformers``
(``save_pretrained``: safetensors, sharded with an index, and ``.bin``).

Tolerances: the loaded parameters are compared exactly (same fp32 values,
or bf16 bits); decode logits of the port on its loaded weights against the
JAX package on its own at 1e-5 (fp32, tiny model: only summation order
differs); against ``transformers`` itself at the JAX package's own 2e-4 /
2e-3."""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import llama as jl
from project_morpheus_tpu.model.hf_weights import config_from_hf as jax_config_from_hf
from project_morpheus_tpu.model.hf_weights import load_hf_checkpoint as jax_load
from project_morpheus_tpu_torch.adapters import runtime as rt
from project_morpheus_tpu_torch.model import hf_weights as hw
from project_morpheus_tpu_torch.model import llama as tl

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

VOCAB = 500  # padded to 512


def _hf_model(tie: bool, seed: int = 0):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=256, rope_theta=500000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=tie, attention_bias=False, mlp_bias=False)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def tied_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tied")
    _hf_model(True).save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def untied_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("untied")
    _hf_model(False, seed=1).save_pretrained(d, safe_serialization=True, max_shard_size="60KB")
    return d


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _assert_params_equal(jp, tp):
    assert set(jp) == set(tp)
    for key in ("embed", "ln_f", "lm_head"):
        if key in jp:
            np.testing.assert_array_equal(_np(tp[key]), np.asarray(jp[key]), err_msg=key)
    assert set(jp["layers"]) == set(tp["layers"])
    for key, v in jp["layers"].items():
        np.testing.assert_array_equal(_np(tp["layers"][key]), np.asarray(v), err_msg=key)


_LLAMA3_ROPE = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}
_BASE = {"vocab_size": 156940, "hidden_size": 3072, "intermediate_size": 8192,
         "num_hidden_layers": 28, "num_attention_heads": 24, "num_key_value_heads": 8,
         "max_position_embeddings": 131072, "rope_theta": 500000.0, "rms_norm_eps": 1e-5}


@pytest.mark.parametrize("hf", [
    {**_BASE, "head_dim": 128, "rope_scaling": _LLAMA3_ROPE, "tie_word_embeddings": True},
    {**_BASE, "rope_scaling": {"type": "llama3", "factor": 8.0}},  # no head_dim, no tie key
    {k: v for k, v in _BASE.items() if k not in ("num_key_value_heads", "rope_theta")},
    {**_BASE, "rope_scaling": None, "tie_word_embeddings": False, "head_dim": 64},
], ids=["orpheus_3b", "no_head_dim", "defaults", "untied"])
def test_config_from_hf_matches_jax(hf):
    assert dataclasses.asdict(hw.config_from_hf(hf)) == dataclasses.asdict(jax_config_from_hf(hf))


@pytest.mark.parametrize("rtype", ["linear", "dynamic", "yarn"])
def test_rejected_rope_type(rtype):
    hf = {**_BASE, "rope_scaling": {"rope_type": rtype, "factor": 2.0}}
    for fn in (hw.config_from_hf, jax_config_from_hf):
        with pytest.raises(ValueError, match="rope_scaling"):
            fn(hf)


def _decode_logits_port(params, cfg, toks):
    cache = tl.init_kv_cache(cfg, 1, 32, torch.float32, "cpu")
    tl.llama_prefill_chunk(params, torch.tensor(toks[:5]), cfg, cache, 0, 0, 5, hist_bucket=32)
    lengths, outs = torch.tensor([5], dtype=torch.int32), []
    for t in range(5, len(toks)):
        outs.append(tl.llama_decode_step(params, torch.tensor(toks[t:t + 1]), cfg, cache,
                                         lengths)[0].numpy())
        lengths = lengths + 1
    return np.stack(outs)


def _decode_logits_jax(params, cfg, toks):
    cache = jl.init_kv_cache(cfg, 1, 32, jnp.float32)
    _, cache = jl.llama_prefill_chunk(params, jnp.asarray(toks[:5]), cfg, cache, jnp.asarray(0),
                                      jnp.asarray(0), jnp.asarray(5), hist_bucket=32)
    lengths, outs = jnp.asarray([5], jnp.int32), []
    for t in range(5, len(toks)):
        logits, cache = jl.llama_decode_step(params, jnp.asarray(toks[t:t + 1]), cfg, cache,
                                             lengths)
        outs.append(np.asarray(logits)[0])
        lengths = lengths + 1
    return np.stack(outs)


@pytest.mark.parametrize("which", ["tied", "untied_sharded"])
def test_params_and_decode_logits_match_jax(which, tied_dir, untied_dir):
    d = tied_dir if which == "tied" else untied_dir
    jp, jcfg = jax_load(str(d), dtype=jnp.float32)
    tp, tcfg = hw.load_hf_checkpoint(d, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.tie_embeddings == (which == "tied")
    _assert_params_equal(jp, tp)
    toks = np.random.default_rng(1).integers(0, VOCAB, 8).astype(np.int32)
    port = _decode_logits_port(tp, tcfg, toks)
    np.testing.assert_allclose(port, _decode_logits_jax(jp, jcfg, toks), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        ref = _hf_model(which == "tied", seed=0 if which == "tied" else 1)(
            torch.tensor(toks[None]).long()).logits[0, 5:].numpy()
    np.testing.assert_allclose(port[:, :VOCAB], ref, rtol=2e-3, atol=2e-4)
    assert not port[:, VOCAB:].any()  # padded vocab rows are zeros


def test_bf16_shards_bit_exact(tmp_path):
    """bf16 shards with an index: the reader's tensors equal
    ``safetensors.torch.load_file``'s bit for bit, and the loaded bf16
    params equal the transposed HF tensors, and the JAX loader's bf16
    params (its ``framework="numpy"`` read of bf16 works because importing
    JAX registers ``ml_dtypes``' bfloat16 with numpy)."""
    model = _hf_model(False, seed=2).to(torch.bfloat16)
    model.save_pretrained(tmp_path, safe_serialization=True, max_shard_size="60KB")
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) >= 2
    state = {}
    for f in shards:
        ours, ref = hw.read_safetensors(tmp_path / f), safetensors_torch.load_file(tmp_path / f)
        assert set(ours) == set(ref)
        for name, t in ref.items():
            assert ours[name].dtype == torch.bfloat16 and torch.equal(ours[name], t), name
        state.update(ref)
    params, cfg = hw.load_hf_checkpoint(tmp_path, dtype=torch.bfloat16, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert torch.equal(params["embed"][:VOCAB], state["model.embed_tokens.weight"])
    assert torch.equal(params["lm_head"][:, :VOCAB], state["lm_head.weight"].T)
    for i in range(cfg.num_layers):
        assert torch.equal(params["layers"]["wq"][i],
                           state[f"model.layers.{i}.self_attn.q_proj.weight"].T)
        assert torch.equal(params["layers"]["ln2"][i],
                           state[f"model.layers.{i}.post_attention_layernorm.weight"])
    jp, _ = jax_load(str(tmp_path), dtype=jnp.bfloat16)
    for key in ("embed", "lm_head", "wq", "wd", "ln1"):
        j = jp[key] if key in jp else jp["layers"][key]
        t = params[key] if key in params else params["layers"][key]
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(j).view(np.int16))


def test_bin_shards_match_jax(tmp_path):
    _hf_model(True, seed=3).save_pretrained(tmp_path, safe_serialization=False,
                                            max_shard_size="60KB")
    assert (tmp_path / "pytorch_model.bin.index.json").exists()
    assert not list(tmp_path.glob("*.safetensors"))
    jp, _ = jax_load(str(tmp_path), dtype=jnp.float32)
    tp, _ = hw.load_hf_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    _assert_params_equal(jp, tp)


def test_tie_inference_from_state_dict(tied_dir, tmp_path):
    """config.json without tie_word_embeddings: tied when the shards hold no
    lm_head.weight (as in the JAX loader); an untied config with no
    lm_head.weight in a state dict is an error."""
    for f in tied_dir.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    cfg_dict = json.loads((tmp_path / "config.json").read_text())
    cfg_dict.pop("tie_word_embeddings", None)
    (tmp_path / "config.json").write_text(json.dumps(cfg_dict))
    assert hw.config_from_hf(cfg_dict).tie_embeddings is False
    params, cfg = hw.load_hf_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    jparams, jcfg = jax_load(str(tmp_path), dtype=jnp.float32)
    assert cfg.tie_embeddings is jcfg.tie_embeddings is True
    assert "lm_head" not in params and "lm_head" not in jparams

    state = dict(safetensors_torch.load_file(tmp_path / "model.safetensors"))
    state["lm_head.weight"] = state["model.embed_tokens.weight"].clone()
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    assert "lm_head" in hw.hf_state_dict_to_params(state, untied, torch.float32, "cpu")
    state.pop("lm_head.weight")
    with pytest.raises(ValueError, match="no lm_head.weight"):
        hw.hf_state_dict_to_params(state, untied, torch.float32, "cpu")


def test_missing_layer_and_vocab_too_large_are_errors(tied_dir):
    state = dict(safetensors_torch.load_file(tied_dir / "model.safetensors"))
    cfg = hw.config_from_hf(json.loads((tied_dir / "config.json").read_text()))
    bad = dict(state)
    bad.pop("model.layers.1.mlp.gate_proj.weight")
    with pytest.raises(ValueError, match="layers missing"):
        hw.hf_state_dict_to_params(bad, cfg, torch.float32, "cpu")
    big = dict(state)
    big["model.embed_tokens.weight"] = torch.zeros(cfg.padded_vocab + 1, cfg.hidden_size)
    with pytest.raises(ValueError, match="exceeds padded vocab"):
        hw.hf_state_dict_to_params(big, cfg, torch.float32, "cpu")
    params = hw.hf_state_dict_to_params(state, cfg, torch.float32, "cpu")
    assert params["embed"].shape[0] == cfg.padded_vocab


def _build_runtime(monkeypatch, **env):
    monkeypatch.setenv("ORPHEUS_ENGINE_MODE", "torch")
    monkeypatch.setenv("ORPHEUS_MODEL_SIZE", "tiny")
    monkeypatch.setenv("ORPHEUS_MAX_SLOTS", "2")
    monkeypatch.setenv("ORPHEUS_MAX_SEQ", "64")
    for k in ("ORPHEUS_CHECKPOINT_PATH", "ORPHEUS_SNAC_PATH", "ORPHEUS_QUANT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runtime = rt.ServingRuntime(device="cpu")

    async def go():
        await runtime.ensure()
        await runtime.engine.close()

    asyncio.run(go())
    return runtime


def test_runtime_builds_from_hf_dir(tied_dir, monkeypatch):
    """ORPHEUS_CHECKPOINT_PATH at an HF release directory: the config comes
    from its config.json, max_position_embeddings does not size the cache."""
    runtime = _build_runtime(monkeypatch, ORPHEUS_CHECKPOINT_PATH=str(tied_dir))
    assert runtime.model_cfg.vocab_size == VOCAB
    assert runtime.model_cfg.max_seq_len == 256
    assert runtime.engine.cache["k"].shape[3] == 64  # ORPHEUS_MAX_SEQ


def test_runtime_rejects_orbax_and_missing_paths(tmp_path, monkeypatch):
    orbax = tmp_path / "orbax_ckpt"
    (orbax / "params").mkdir(parents=True)
    (orbax / "llama_config.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="training"):
        _build_runtime(monkeypatch, ORPHEUS_CHECKPOINT_PATH=str(orbax))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        _build_runtime(monkeypatch, ORPHEUS_CHECKPOINT_PATH=str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="snac_missing"):
        _build_runtime(monkeypatch, ORPHEUS_SNAC_PATH=str(tmp_path / "snac_missing.npz"))


def test_chip_smoke_writers_read_by_hf_libraries(tmp_path):
    """``chip_smoke.py``'s HF directory and tokenizer writers (phase 7)
    produce what ``safetensors``, ``transformers`` and ``tokenizers`` read:
    the shards equal the params in HF layout bit for bit; transformers'
    Llama (llama3 rope scaling, untied) on them gives the port's logits on
    its own load of them (2e-4 / 2e-3, as above); the port's tokenizer
    equals ``HFTokenizer`` on the written tokenizer.json."""
    import chip_smoke
    from project_morpheus_tpu.model.tokenizer import HFTokenizer
    from project_morpheus_tpu_torch.model.config import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.model.tokenizer import BPETokenizer

    cfg = LlamaConfig(vocab_size=1000, hidden_size=64, intermediate_size=128, num_layers=3,
                      num_heads=4, num_kv_heads=2, head_dim=16, tie_embeddings=False)
    params = init_llama_params(cfg, 3, "cpu", torch.bfloat16)
    params["embed"][cfg.vocab_size:] = 0
    params["lm_head"][:, cfg.vocab_size:] = 0
    chip_smoke.write_hf_checkpoint(tmp_path, params, cfg, shards=3)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    state = {}
    for f in sorted(set(index["weight_map"].values())):
        state.update(safetensors_torch.load_file(tmp_path / f))
    want = dict(chip_smoke.hf_tensors(params, cfg))
    assert set(state) == set(want) == set(index["weight_map"])
    for name, t in want.items():
        assert torch.equal(state[name], t.contiguous()), name

    loaded, lcfg = hw.load_hf_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    fields = [f for f in dataclasses.asdict(cfg) if f not in ("max_seq_len", "dtype")]
    assert all(getattr(lcfg, f) == getattr(cfg, f) for f in fields)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, 9).astype(np.int32)
    port = _decode_logits_port(loaded, lcfg, toks)
    model = transformers.LlamaForCausalLM.from_pretrained(tmp_path, torch_dtype=torch.float32)
    with torch.no_grad():
        ref = model.eval()(torch.tensor(toks[None]).long()).logits[0, 5:].numpy()
    np.testing.assert_allclose(port[:, :cfg.vocab_size], ref, rtol=2e-3, atol=2e-4)

    chip_smoke.write_tokenizer(tmp_path, 128256 + 40)
    ours, theirs = BPETokenizer(tmp_path), HFTokenizer(str(tmp_path))
    for text in ("tara: Hello there, the weather is nice.", "Café 123456 <custom_token_5>",
                 "<|eot_id|>in the    rest\n\nof it", "the other one's"):
        ids = ours.encode(text)
        assert ids == theirs.encode(text) and ours.decode(ids) == theirs.decode(ids)
    assert ours.encode("<custom_token_39><|eot_id|>") == [128256 + 39, 128009]
