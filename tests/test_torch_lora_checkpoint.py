"""The port's LoRA (``training/lora.py``) against the JAX package's, and its
checkpoints (``training/checkpoint.py``): save/restore, the newest-step
fallback, bf16 bit for bit, a killed and resumed run equal to a straight
one, and ``ServingRuntime`` serving a checkpoint the trainer wrote.

fp32 on the CPU, weights and adapters drawn with ``jax.random`` and
carried across with ``model/bridge.py``.  Tolerances: forward and loss
1e-5 relative; merged weights 1e-6 of the largest magnitude; adapter
updates after AdamW steps 1e-3 in relative L2 norm, as in
``test_torch_training.py`` (which says why); round trips, the frozen base,
kill/resume and served tokens exact."""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model import init_llama_params as jax_init
from project_morpheus_tpu.training import lora as jlora
from project_morpheus_tpu.training import pretrain as jpre
from project_morpheus_tpu_torch.adapters import runtime as rt
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy
from project_morpheus_tpu_torch.model.llama import init_llama_params, llama_forward
from project_morpheus_tpu_torch.model.sampling import SamplingParams
from project_morpheus_tpu_torch.training import checkpoint as ck
from project_morpheus_tpu_torch.training import data as tdata
from project_morpheus_tpu_torch.training import lora as tlora
from project_morpheus_tpu_torch.training import pretrain as tpre

CFG = LlamaConfig.tiny_vocab()
LC = tlora.LoraConfig(rank=4)


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(3), dtype=jnp.float32)


def _carry(tree):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree))


def _leaves(tree):
    return tpre.tree_leaves(tree)


def _batch(seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    return tdata.pad_collate([{"input_ids": rng.integers(1, 1000, S).tolist()}
                              for _ in range(B)])


def test_lora_trees_carry_across_and_zero_init_is_identity(jparams):
    """The bridge's tree walker carries JAX's adapter tree leaf for leaf;
    the port's own zero-B adapters leave the forward bit-identical."""
    jl = jlora.init_lora_params(JaxLlamaConfig.tiny_vocab(), jlora.LoraConfig(rank=4, train_embed=True),
                                jax.random.key(0))
    tl = _carry(jl)
    assert set(tl) == set(jl) and set(tl["layers"]) == set(jlora.PROJ_NAMES)
    for name in jlora.PROJ_NAMES:
        for ab in ("a", "b"):
            np.testing.assert_array_equal(tl["layers"][name][ab].numpy(),
                                          np.asarray(jl["layers"][name][ab]))
    own = tlora.init_lora_params(CFG, LC, seed=0, device="cpu")
    assert {n: (v["a"].shape, v["b"].shape) for n, v in own["layers"].items()} == \
        {n: (tuple(v["a"].shape), tuple(v["b"].shape)) for n, v in jl["layers"].items()}
    toks = torch.tensor([[1, 2, 3, 4]])
    base, _ = llama_forward(_carry(jparams), toks, CFG)
    with_lora, _ = llama_forward(_carry(jparams), toks, CFG, lora=own,
                                 lora_scale=tlora.lora_scale(LC))
    assert torch.equal(base, with_lora)
    assert tlora.lora_scale(LC) == jlora.lora_scale(jlora.LoraConfig(rank=4))


def test_lora_steps_match_jax(jparams):
    """Two LoRA steps (warmup 1, so the first at rate 0): losses and
    adapters as JAX's, the base params bit-identical, the adapters moved."""
    tc = tpre.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jl = jlora.init_lora_params(JaxLlamaConfig.tiny_vocab(), jlora.LoraConfig(rank=4),
                                jax.random.key(1))
    jopt = jpre.make_optimizer(tc)
    jstate, jstep = jopt.init(jl), jlora.make_lora_train_step(CFG, jlora.LoraConfig(rank=4), jopt)
    base = _carry(jparams)
    base_copy = [t.clone() for t in _leaves(base)]
    lora, start = _carry(jl), _carry(jl)
    opt = tpre.make_optimizer(tc)
    state, step = opt.init(lora), tlora.make_lora_train_step(CFG, LC, opt)
    for i in range(2):
        batch = _batch(i)
        jl, jstate, jloss = jstep(jl, jstate, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        lora, state, loss = step(lora, state, base, batch)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(base), base_copy))
    assert all(not p.requires_grad for p in _leaves(base))
    assert float(lora["layers"]["wq"]["b"].detach().abs().sum()) > 0
    num = den = 0.0
    for got, s, want in zip(_leaves(lora), _leaves(start), jax.tree.leaves(jl)):
        d_want = np.asarray(want, np.float64) - s.double().numpy()
        num += float((((got.detach() - s).double().numpy() - d_want) ** 2).sum())
        den += float((d_want ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def test_merge_lora_matches_jax(jparams):
    jl = jlora.init_lora_params(JaxLlamaConfig.tiny_vocab(), jlora.LoraConfig(rank=4),
                                jax.random.key(2))
    for i, name in enumerate(jlora.PROJ_NAMES):
        b = jl["layers"][name]["b"]
        jl["layers"][name]["b"] = jax.random.normal(jax.random.key(20 + i), b.shape) * 0.01
    want = jlora.merge_lora(jparams, jl, jlora.LoraConfig(rank=4))
    got = tlora.merge_lora(_carry(jparams), _carry(jl), LC)
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()
    toks = torch.tensor([[7, 8, 9]])
    via_adapter, _ = llama_forward(_carry(jparams), toks, CFG, lora=_carry(jl),
                                   lora_scale=tlora.lora_scale(LC))
    via_merged, _ = llama_forward(got, toks, CFG)
    assert (via_adapter - via_merged).abs().max() <= 1e-5 * via_adapter.abs().max()


def test_checkpoint_roundtrip_and_latest(tmp_path):
    params = init_llama_params(CFG, 5, "cpu", torch.bfloat16)
    path = ck.save_params(tmp_path / "ckpt", params, step=7, cfg=CFG)
    assert path.endswith("step_7")
    cfg_json = json.loads((tmp_path / "ckpt" / "llama_config.json").read_text())
    assert LlamaConfig(**cfg_json) == CFG
    back = ck.restore_params(tmp_path / "ckpt", step=7, device="cpu")
    assert back.keys() == params.keys() and back["layers"].keys() == params["layers"].keys()
    for a, b in zip(_leaves(back), _leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    zeros = tpre.tree_map(torch.zeros_like, params)
    ck.save_params(tmp_path / "ckpt", zeros, step=10)
    assert ck.latest_step(tmp_path / "ckpt") == 10
    newest = ck.restore_params(tmp_path / "ckpt", device="cpu")  # no latest/: step_10
    assert float(newest["embed"].abs().sum()) == 0.0
    ck.save_params(tmp_path / "ckpt", params)  # latest/ now wins
    assert torch.equal(ck.restore_params(tmp_path / "ckpt", device="cpu")["embed"],
                       params["embed"])
    assert ck.latest_step(tmp_path / "nothing") is None
    with pytest.raises(FileNotFoundError):
        ck.restore_params(tmp_path / "nothing", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        ck.save_params(tmp_path / "int", {"q": torch.zeros(3, dtype=torch.int8)})


def test_kill_resume_matches_straight_run(jparams, tmp_path):
    """A run stopped after 3 steps (the full state saved) and resumed for
    3 more ends with the same params, bit for bit, as 6 steps straight:
    moments, schedule count and data cursor all restore."""
    def batches():
        rng = np.random.default_rng(7)
        text, audio = ([{"input_ids": rng.integers(1, 1000, 8).tolist()} for _ in range(12)]
                       for _ in range(2))
        return iter(tdata.BatchedRatioDataset(text, audio, batch_size=4, ratio=1))

    tc = tpre.TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6, seq_len=8,
                          save_steps=3, log_every=100)
    straight, hist_a = tpre.train_loop(_carry(jparams), CFG, batches(), tc=tc, device="cpu")
    tpre.train_loop(_carry(jparams), CFG, batches(), tc=dataclasses.replace(tc, total_steps=3),
                    checkpoint_dir=str(tmp_path / "run"), device="cpu")
    assert ck.latest_step(tmp_path / "run") == 3
    logs = []
    resumed, hist_b = tpre.train_loop(_carry(jparams), CFG, batches(), tc=tc, log=logs.append,
                                      checkpoint_dir=str(tmp_path / "run"), device="cpu")
    assert {"resumed_at_step": 3} in logs
    assert len(hist_b["text_loss"]) + len(hist_b["audio_loss"]) == 3
    assert hist_b["text_loss"] == hist_a["text_loss"][-len(hist_b["text_loss"]):]
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        assert torch.equal(a, b)
    assert ck.latest_step(tmp_path / "run") == 6


def _serve(runtime):
    async def go():
        await runtime.ensure()
        eng = runtime.engine
        reqs = [await eng.submit([5 + i, 17, 300 + i],
                                 SamplingParams(temperature=0.9, max_tokens=12,
                                                stop_token_ids=(), seed=3 + i))
                for i in range(2)]
        out = [[t async for t in r.tokens()] for r in reqs]
        await eng.close()
        return out

    return asyncio.run(go())


def test_runtime_serves_port_checkpoint(tmp_path, monkeypatch):
    """``ORPHEUS_CHECKPOINT_PATH`` at a directory ``save_params`` wrote:
    the config comes from ``llama_config.json`` and two seeded requests
    give the tokens of a runtime handed the same params; an orbax
    directory still raises."""
    cfg = dataclasses.replace(LlamaConfig.tiny_vocab(), num_layers=3)
    params = init_llama_params(cfg, 9, "cpu", torch.float32)
    ck.save_params(tmp_path / "trained", params, step=4, cfg=cfg)
    for k, v in dict(ORPHEUS_ENGINE_MODE="torch", ORPHEUS_MODEL_SIZE="tiny",
                     ORPHEUS_MAX_SLOTS="2", ORPHEUS_MAX_SEQ="64").items():
        monkeypatch.setenv(k, v)
    for k in ("ORPHEUS_SNAC_PATH", "ORPHEUS_QUANT", "ORPHEUS_CHECKPOINT_PATH"):
        monkeypatch.delenv(k, raising=False)
    direct = rt.ServingRuntime(device="cpu")
    direct.build(loaded=(params, cfg))
    want = _serve(direct)
    monkeypatch.setenv("ORPHEUS_CHECKPOINT_PATH", str(tmp_path / "trained"))
    loaded = rt.ServingRuntime(device="cpu")
    got = _serve(loaded)
    assert loaded.model_cfg == cfg
    assert got == want and all(len(t) == 12 for t in got)
    orbax = tmp_path / "orbax_ckpt"
    (orbax / "params").mkdir(parents=True)
    (orbax / "llama_config.json").write_text("{}")
    monkeypatch.setenv("ORPHEUS_CHECKPOINT_PATH", str(orbax))
    with pytest.raises(NotImplementedError, match="orbax"):
        rt.ServingRuntime(device="cpu").load_params()


def test_embed_delta_takes_no_step_as_in_jax(jparams):
    """``train_embed=True`` adds an ``embed_delta`` that the JAX forward
    never reads, so its gradient is zero and it stays zero through AdamW
    (weight decay of zero included); the port matches that as is."""
    tc = tpre.TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10)
    jlc = jlora.LoraConfig(rank=4, train_embed=True)
    jl = jlora.init_lora_params(JaxLlamaConfig.tiny_vocab(), jlc, jax.random.key(4))
    jopt = jpre.make_optimizer(tc)
    batch = _batch(5)
    jl, _, _ = jlora.make_lora_train_step(CFG, jlc, jopt)(
        jl, jopt.init(jl), jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    lc = tlora.LoraConfig(rank=4, train_embed=True)
    lora = tlora.init_lora_params(CFG, lc, seed=4, device="cpu")
    opt = tpre.make_optimizer(tc)
    lora, _, _ = tlora.make_lora_train_step(CFG, lc, opt)(lora, opt.init(lora), _carry(jparams),
                                                           batch)
    assert not np.asarray(jl["embed_delta"]).any()
    assert not lora["embed_delta"].detach().any()
    assert float(lora["layers"]["wq"]["a"].detach().abs().sum()) > 0
