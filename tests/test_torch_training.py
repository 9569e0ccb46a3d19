"""The port's trainer (``training/pretrain.py``, ``training/data.py``)
against the JAX package's: batching and collation, the loss (dense and
chunked-vocab) and its grads against ``jax.grad``, optax's schedule,
clipping and AdamW, three train steps, a ``train_loop`` of three batches,
and the grouped-gradient step against the monolithic one.

All fp32 on the CPU, weights drawn with ``jax.random`` and carried across
with ``model/bridge.py``.  Tolerances: loss 1e-5 relative; grads 1e-4 of
the largest reference magnitude; schedule 1e-7 of the peak rate;
clipping 1e-7 of the largest reference magnitude (the norm's float32 sums
run in another order than XLA's, one float32 step apart at most); data
exact.  Params after AdamW steps: AdamW divides each gradient element
by its own running RMS, so a 1e-6 difference in a near-zero gradient
element can move that element by a sizeable part of the learning rate;
the updates (trained minus initial params) must agree to 5e-2 x lr per
step taken at a nonzero rate, a small part of one step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model import init_llama_params as jax_init
from project_morpheus_tpu.parallel import make_mesh
from project_morpheus_tpu.training import data as jdata
from project_morpheus_tpu.training import pretrain as jpre
from project_morpheus_tpu_torch.model import LlamaConfig
from project_morpheus_tpu_torch.model.bridge import group_layer_params, params_from_jax_numpy
from project_morpheus_tpu_torch.training import data as tdata
from project_morpheus_tpu_torch.training import pretrain as tpre

CFG = LlamaConfig.tiny_vocab()


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(3), dtype=jnp.float32)


def _carry(tree):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree))


def _examples(n, length=12, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(1, 1000, size=(length,)).tolist()} for _ in range(n)]


def _batch(seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 1000, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[0, :5] = -100
    mask = np.ones((B, S), bool)
    mask[1, S - 6:] = False
    labels[1, S - 6:] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def test_data_matches_jax():
    text, audio = _examples(9, seed=1), _examples(5, seed=2)
    for ratio, bs in ((1, 2), (2, 2), (3, 1)):
        got = list(tdata.BatchedRatioDataset(text, audio, bs, ratio))
        assert got == list(jdata.BatchedRatioDataset(text, audio, bs, ratio))
    assert tdata.shard_for_rank(text, 1, 4) == jdata.shard_for_rank(text, 1, 4)
    ragged = [{"input_ids": [1, 2, 3]}, {"input_ids": [4, 5]}, {"input_ids": list(range(9))}]
    for max_len in (None, 4):
        got, want = tdata.pad_collate(ragged, max_len), jdata.pad_collate(ragged, max_len)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert (tdata.PAD_ID, tdata.IGNORE_LABEL) == (jdata.PAD_ID, jdata.IGNORE_LABEL)
    assert tpre.resolve_attn(512) == ("dense", False)
    assert tpre.resolve_attn(8192) == ("blockwise", True)
    assert tpre.resolve_attn(8192, attn_impl="dense", remat="off") == ("dense", False)


@pytest.mark.parametrize("attn_impl,chunk", [("dense", 0), ("dense", 8), ("blockwise", 0),
                                              ("blockwise", 7)])
def test_loss_and_grads_match_jax(jparams, attn_impl, chunk):
    """Dense and chunked-vocab loss (chunks that do not divide the
    length), ignored labels and padding: the loss and every leaf's grad."""
    batch = _batch(0)
    jloss = jax.jit(jax.value_and_grad(jpre.causal_lm_loss),
                    static_argnames=("cfg", "attn_impl", "logits_chunk"))
    want, jgrads = jloss(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, CFG,
                         attn_impl=attn_impl, logits_chunk=chunk)
    params = _carry(jparams)
    leaves = tpre.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    got = tpre.causal_lm_loss(params, batch, CFG, attn_impl=attn_impl, logits_chunk=chunk,
                              remat=True)
    grads = torch.autograd.grad(got, leaves)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert len(grads) == len(jax.tree.leaves(jgrads))
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        assert _rel(g, jg) < 1e-4


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 5), (3, 2), (100, 10_000)])
def test_schedule_matches_optax(warmup, total):
    """To 1e-7 of the peak rate (optax computes in float32, the port in
    float64; near the cosine's end 1 + cos loses float32's relative
    precision, not the peak's).  Including the optimizer's own rate after
    each update: optax reads the schedule at the count before the update,
    so with warmup the first step's rate is 0."""
    tc = tpre.TrainConfig(learning_rate=1e-3, warmup_steps=warmup, total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(0.0, tc.learning_rate, warmup,
                                               max(total, warmup + 1))
    counts = list(range(0, min(total + 3, 40))) + [total // 2, total - 1, total]
    for c in counts:
        want = float(sched(c))
        got = tpre.warmup_cosine_lr(tc, c)
        assert abs(got - want) <= 1e-7 * tc.learning_rate, (c, got, want)
    state = tpre.make_optimizer(tc).init({"w": torch.zeros(3)})
    for c in range(4):
        assert state.adamw.param_groups[0]["lr"] == tpre.warmup_cosine_lr(tc, c)
        tpre.make_optimizer(tc).update([torch.ones(3)], state)
        assert state.count == c + 1


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(7, 3)) * scale, "b": rng.normal(size=(11,)) * scale}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, optax.EmptyState())
    got = tpre.clip_by_global_norm([torch.tensor(tree[k]) for k in ("a", "b")], 1.0)
    for g, k in zip(got, ("a", "b")):
        assert _rel(g, want[k]) <= 1e-7
    norm = float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in tree.values())))
    assert abs(float(tpre.global_norm(got)) - min(norm, 1.0)) <= 1e-6 * min(norm, 1.0)


def _assert_updates_close(p1, p0, jp1):
    """The updates (trained less initial params, over every leaf) agree to
    1e-3 in relative L2 norm."""
    num = den = 0.0
    for got, start, want in zip(tpre.tree_leaves(p1), tpre.tree_leaves(p0), jax.tree.leaves(jp1)):
        d_want = np.asarray(want, np.float64) - start.double().numpy()
        num += float((((got.detach().double() - start.double()).numpy() - d_want) ** 2).sum())
        den += float((d_want ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def test_train_steps_match_jax(jparams):
    """Three steps of ``make_train_step`` (warmup 1: the first at rate 0,
    clipping active), fp32 AdamW moments: losses, and the params after."""
    tc = tpre.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=6, max_grad_norm=0.5)
    start = _carry(jparams)
    params = _carry(jparams)
    jp = jax.tree.map(jnp.array, jparams)  # the JAX step donates its inputs
    jopt = jpre.make_optimizer(tc)
    jstate, jstep = jopt.init(jp), jpre.make_train_step(CFG, jopt)
    opt = tpre.make_optimizer(tc)
    state, step = opt.init(params), tpre.make_train_step(CFG, opt)
    for i in range(3):
        batch = _batch(10 + i)
        jp, jstate, jl = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, loss = step(params, state, batch)
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)), i
    assert state.count == 3 and int(jstate[1][0].count) == 3
    _assert_updates_close(params, start, jp)


def _loop_batches():
    text = _examples(8, length=8, seed=7) * 2
    audio = _examples(8, length=8, seed=8)
    return iter(tdata.BatchedRatioDataset(text, audio, batch_size=8, ratio=1))


def test_train_loop_matches_jax(jparams):
    """``train_loop`` over 3 interleaved batches: per-stream loss history,
    the returned (stacked) params, and the input params untouched."""
    tc = tpre.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3, seq_len=8,
                          log_every=1)
    start = _carry(jparams)
    given = _carry(jparams)
    jp, jhist = jpre.train_loop(jax.tree.map(jnp.array, jparams), CFG, _loop_batches(), tc=tc,
                                mesh=make_mesh(model=1))
    logs = []
    params, hist = tpre.train_loop(given, CFG, _loop_batches(), tc=tc, log=logs.append,
                                   device="cpu")
    assert [len(hist[k]) for k in ("text_loss", "audio_loss")] == [2, 1]
    for k in ("text_loss", "audio_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5)
    assert [r["step"] for r in logs] == [0, 1, 2]
    assert not isinstance(params["layers"], list)
    _assert_updates_close(params, start, jp)
    assert all(torch.equal(a, b) for a, b in zip(tpre.tree_leaves(given),
                                                 tpre.tree_leaves(start)))


def test_grouped_grad_step_matches_monolithic(jparams):
    """Two gradient passes (one per layer group) and one update give the
    monolithic step's loss and params."""
    tc = tpre.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=4)
    batch = _batch(3, S=40)
    opt = tpre.make_optimizer(tc)
    p1 = _carry(jparams)
    s1 = opt.init(p1)
    p1, _, l1 = tpre.make_train_step(CFG, opt, stack_grad="scan")(p1, s1, batch)
    p2 = group_layer_params(_carry(jparams), 2)
    s2 = opt.init(p2)
    p2, _, l2 = tpre.make_grouped_grad_step(CFG, opt, 2)(p2, s2, batch)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    p2 = tpre.ungroup_layer_params(p2)
    _assert_updates_close(p2, _carry(jparams), [a.detach().numpy() for a in tpre.tree_leaves(p1)])
    with pytest.raises(ValueError, match="group_layer_params"):
        tpre.make_grouped_grad_step(CFG, opt, 3)(p2, s2, batch)


def test_one_card_only(jparams, monkeypatch):
    """Without a mesh the trainer runs on one device, whatever
    ``shard_mode`` or ``WORLD_SIZE`` say (the sharded path is
    ``tests/test_torch_multiprocess.py``); an unknown mode on a mesh and a
    mesh on another device raise."""
    from project_morpheus_tpu_torch.parallel import make_mesh as port_mesh

    args = (_carry(jparams), CFG, iter([]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    for kw in (dict(shard_mode="fsdp_tp"), dict()):
        _, hist = tpre.train_loop(*args, device="cpu", **kw)
        assert hist == {"text_loss": [], "audio_loss": []}
    with pytest.raises(ValueError, match="unknown sharding mode"):
        tpre.train_loop(*args, device="cpu", mesh=port_mesh(device="cpu"), shard_mode="zero")
    with pytest.raises(ValueError, match="mesh on"):
        tpre.train_loop(*args, device="cpu", mesh=port_mesh(device="meta"))
    assert not hasattr(tpre, "check_single_device")
    assert dataclasses.asdict(tpre.TrainConfig()) == dataclasses.asdict(jpre.TrainConfig())
