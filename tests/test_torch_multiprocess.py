"""Multi-process training of the port on the CPU: ranks of
``torch.distributed`` over gloo (``tests/torch_multiproc_worker.py``),
each on its data rank's strided share of the global batch.

- 2 ranks, ``fsdp`` on a (2, 1) mesh; 4 ranks, ``fsdp_tp`` on a (2, 2)
  mesh: the losses, the trained params and the clipping norm equal the
  port's single-process run on the global batch (which
  ``test_torch_training.py`` holds to the JAX trainer) within fp32
  summation-order tolerance;
- the checkpoint rank 0 writes (whole tensors) restores onto the mesh as
  each rank's shards, and serves through ``ORPHEUS_CHECKPOINT_PATH``;
- the bf16 gradient norm of the port's ``global_norm`` (fp32 sums)
  against optax's (sums in bf16), measured.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_multiproc_worker import launch  # noqa: E402

from project_morpheus_tpu_torch.model.bridge import group_layer_params, tree_leaves  # noqa: E402
from project_morpheus_tpu_torch.model.config import LlamaConfig  # noqa: E402
from project_morpheus_tpu_torch.model.llama import init_llama_params  # noqa: E402
from project_morpheus_tpu_torch.training import pretrain  # noqa: E402
from project_morpheus_tpu_torch.training.data import pad_collate  # noqa: E402

CFG = LlamaConfig.tiny()
EXAMPLES = [{"input_ids": [(7 * i + j) % 900 + 3 for j in range(10 + i % 3)]} for i in range(4)]
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3, seq_len=12, log_every=100)


@pytest.fixture(scope="module")
def single():
    """The single-process run on the global batch: losses, params, norm."""
    params = init_llama_params(CFG, 0, "cpu", torch.float32)
    tc = pretrain.TrainConfig(**TC)
    batches = [{"examples": EXAMPLES, "kind": "text"}] * 3
    trained, hist = pretrain.train_loop(params, CFG, iter(batches), tc=tc, device="cpu")
    grouped = group_layer_params(params, CFG.num_layers)
    leaves = tree_leaves(grouped)
    for p in leaves:
        p.requires_grad_(True)
    loss = pretrain.causal_lm_loss(grouped, pad_collate(EXAMPLES, max_len=12), CFG)
    norm = float(pretrain.global_norm(torch.autograd.grad(loss, leaves)))
    return hist["text_loss"], _flat(trained), norm, _flat(params)


def _flat(tree):
    return {f"{k}.{kk}" if kk else k: vv.detach().numpy()
            for k, v in tree.items()
            for kk, vv in (v.items() if isinstance(v, dict) else [("", v)])}


def _run(tmp_path, data, model, mode):
    inp = {"cfg": CFG.__dict__, "seed": 0, "data": data, "model": model, "mode": mode,
           "examples": EXAMPLES, "steps": 3, "tc": TC, "ckpt": str(tmp_path / "ckpt")}
    return launch(tmp_path, "train", inp, data * model)


def _check(results, single, local_wq):
    losses, params, norm, start = single
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-6)
        assert r["restored_ok"], "restored shards differ from the trained ones"
        assert r["local_shape"] == local_wq
        assert r["grad_norm"] == pytest.approx(norm, rel=2e-6)
    got = results[0]["params"]
    assert set(got) == set(params)
    # The updates (trained less initial params) agree to 1e-5 in relative
    # L2 norm over every leaf, and each weight to 1% of lr x steps: AdamW's
    # first steps move a weight by about the learning rate whatever its
    # gradient's size, so summation order can move the m / sqrt(v) of a
    # near-zero gradient by a visible fraction of one step.
    num = den = 0.0
    for k, want in params.items():
        d_want = want.astype(np.float64) - start[k]
        d_got = got[k].astype(np.float64) - start[k]
        num += float(((d_got - d_want) ** 2).sum())
        den += float((d_want ** 2).sum())
        np.testing.assert_allclose(got[k], want, rtol=0, atol=0.01 * 1e-3 * 3, err_msg=k)
    assert den > 0 and (num / den) ** 0.5 <= 1e-5


def test_two_process_fsdp_train_step(tmp_path, single, monkeypatch):
    results = _run(tmp_path, 2, 1, "fsdp")
    D, HD = CFG.hidden_size, CFG.head_dim
    _check(results, single, (CFG.num_layers, D // 2, CFG.num_heads * HD))
    # rank 0's checkpoint is whole tensors in the single-device layout,
    # and serves as it is
    from project_morpheus_tpu_torch.adapters.runtime import ServingRuntime

    monkeypatch.setenv("ORPHEUS_CHECKPOINT_PATH", str(tmp_path / "ckpt"))
    monkeypatch.setenv("ORPHEUS_MODEL_SIZE", "tiny")
    loaded, cfg = ServingRuntime(device="cpu").load_params()
    assert cfg == CFG
    for k, v in results[0]["params"].items():
        node = loaded
        for part in k.split("."):
            node = node[part]
        np.testing.assert_array_equal(node.numpy(), v, err_msg=k)
    _serve_equal(loaded, single[1])


def _serve_equal(loaded, single_params):
    """Greedy traces of the checkpoint equal those of the single-process
    trained params."""
    import asyncio

    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
    from project_morpheus_tpu_torch.model.sampling import SamplingParams

    ref = {"embed": torch.from_numpy(single_params["embed"]),
           "ln_f": torch.from_numpy(single_params["ln_f"]),
           "layers": {k.split(".")[1]: torch.from_numpy(v)
                      for k, v in single_params.items() if k.startswith("layers.")}}

    async def trace(params):
        eng = OrpheusEngine(params, CFG, EngineConfig(max_slots=2, max_seq_len=64,
                                                      prefill_buckets=(16,)), device="cpu")
        req = await eng.submit([5, 6, 8, 9], SamplingParams(temperature=0.0, max_tokens=8,
                                                            stop_token_ids=()))
        out = [t async for t in req.tokens()]
        await eng.close()
        return out

    assert asyncio.run(trace(loaded)) == asyncio.run(trace(ref))


def test_four_process_fsdp_tp_train_step(tmp_path, single):
    """2 x 2: hidden over data, heads / ffn / vocab over model."""
    results = _run(tmp_path, 2, 2, "fsdp_tp")
    D, HD = CFG.hidden_size, CFG.head_dim
    _check(results, single, (CFG.num_layers, D // 2, CFG.num_heads * HD // 2))


def test_bf16_global_norm_against_optax():
    """Gradients of a bf16 model: the port sums each leaf's squares in
    fp32, optax in bf16.  Both against an fp64 sum of the same bf16
    values; prints the relative errors."""
    import jax.numpy as jnp
    import optax

    cfg = LlamaConfig.tiny()
    params = group_layer_params(init_llama_params(cfg, 3, "cpu", torch.bfloat16), cfg.num_layers)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ex = [{"input_ids": [(11 * i + 5 * j) % 900 + 3 for j in range(64)]} for i in range(4)]
    loss = pretrain.causal_lm_loss(params, pad_collate(ex, max_len=64), cfg)
    grads = torch.autograd.grad(loss, leaves)
    exact = float(np.sqrt(sum((g.double() ** 2).sum().item() for g in grads)))
    ours = float(pretrain.global_norm(grads))
    theirs = float(optax.global_norm([jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
                                      for g in grads]))
    err_ours, err_theirs = abs(ours - exact) / exact, abs(theirs - exact) / exact
    print(f"bf16 grad norm: fp64 {exact:.8g}, port (fp32 sums) {ours:.8g} rel err "
          f"{err_ours:.3g}, optax (bf16 sums) {theirs:.8g} rel err {err_theirs:.3g}")
    assert err_ours < 1e-6
    assert err_theirs < 2e-2  # bf16 keeps 8 bits of mantissa


def test_torchrun_cli_tensor_parallel_matches_single_process(tmp_path):
    """``torchrun --nproc_per_node 2`` of the training CLI with
    ``tensor_parallel: 2`` (a 1 x 2 mesh, ``fsdp_tp``) on the CPU: one
    process logs, rank 0's checkpoint holds whole tensors, and the losses
    equal the single-process CLI's on the same records."""
    import json
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    rng = np.random.default_rng(0)
    for name, n in (("text", 8), ("audio", 4)):
        with open(tmp_path / f"{name}.jsonl", "w") as fh:
            for _ in range(n):
                fh.write(json.dumps({"input_ids": rng.integers(1, 1000, 8).tolist()}) + "\n")
    base = (f"model_size: tiny_vocab\nbatch_size: 2\ntotal_steps: 2\nseq_length: 8\n"
            f"learning_rate: 1e-3\nwarmup_steps: 1\nbf16: false\n"
            f"text_data: {tmp_path}/text.jsonl\naudio_data: {tmp_path}/audio.jsonl\n")
    (tmp_path / "tp.yaml").write_text(base + f"tensor_parallel: 2\ncheckpoint_dir: {tmp_path}/tp\n")
    (tmp_path / "one.yaml").write_text(base + f"checkpoint_dir: {tmp_path}/one\n")
    env = {"PYTHONPATH": str(repo), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"}
    cli = ["-m", "project_morpheus_tpu_torch.training", "pretrain", "--device", "cpu", "--config"]
    runs = {}
    for name, pre in (("tp", ["-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", "2"]), ("one", [])):
        res = subprocess.run([sys.executable, *pre, *cli, str(tmp_path / f"{name}.yaml")],
                             capture_output=True, text=True, cwd=repo, env=env, timeout=240)
        assert res.returncode == 0, res.stderr[-3000:]
        runs[name] = [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]
    assert len(runs["tp"]) == len(runs["one"]) == 1  # step 0 only (log_every 10), rank 0 only
    assert runs["tp"][0]["text_loss"] == pytest.approx(runs["one"][0]["text_loss"], rel=1e-6)
    from project_morpheus_tpu_torch.training.checkpoint import restore_params

    tp, one = (restore_params(tmp_path / n, step=2, device="cpu") for n in ("tp", "one"))
    assert tp["layers"]["wq"].shape == one["layers"]["wq"].shape == (2, 64, 64)
    for a, b in zip(tree_leaves(tp), tree_leaves(one), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2 * 1e-3 * 0.01)
