"""One rank of the port's multi-process CPU tests (gloo over a ``file://``
store): ``python tests/torch_multiproc_worker.py <scenario> <in.pkl>
<out_dir>`` with ``RANK`` and ``WORLD_SIZE`` set.  It imports the port
only (no JAX) and writes ``<out_dir>/rank<R>.pkl``.

Scenarios (``in.pkl`` holds their inputs):

- ``train``: ``train_loop`` on a ``(data, model)`` mesh in ``mode``, each
  data rank on its strided share of the global examples, with a
  checkpoint directory; also restores the written train state onto the
  mesh and checks it against this rank's shards.
- ``decode``: prefill + decode steps with the ``tp`` shards of params from
  the JAX package (numpy leaves), logits gathered on every rank.
- ``engine``: an ``OrpheusEngine`` on the mesh serving the given requests.
"""
import asyncio
import os
import pickle
import sys
from pathlib import Path

import torch


def _setup(store: str):
    from project_morpheus_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    assert initialize_distributed(f"file://{store}", world, rank, device="cpu",
                                  timeout_s=90) is (world > 1)
    return rank


def train(inp, rank):
    from project_morpheus_tpu_torch.model.bridge import tree_leaves
    from project_morpheus_tpu_torch.model.config import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.parallel import make_mesh
    from project_morpheus_tpu_torch.parallel.training import TrainShards
    from project_morpheus_tpu_torch.training.checkpoint import restore_train_state
    from project_morpheus_tpu_torch.training.data import shard_for_rank
    from project_morpheus_tpu_torch.training.pretrain import TrainConfig, train_loop

    cfg = LlamaConfig(**inp["cfg"])
    params = init_llama_params(cfg, inp["seed"], "cpu", torch.float32)
    mesh = make_mesh(inp["data"], inp["model"], device="cpu")
    local = shard_for_rank(inp["examples"], mesh.coords["data"], mesh.shape["data"])
    batches = [{"examples": local, "kind": "text"}] * inp["steps"]
    tc = TrainConfig(**inp["tc"])
    trained, hist = train_loop(params, cfg, iter(batches), tc=tc, mesh=mesh,
                               shard_mode=inp["mode"], checkpoint_dir=inp["ckpt"], device="cpu")
    restored = restore_train_state(inp["ckpt"], device="cpu", mesh=mesh, shard_mode=inp["mode"])
    shards = TrainShards(mesh, inp["mode"], params)
    mine = shards.cut(trained)
    restored_ok = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(restored["params"]), tree_leaves(mine), strict=True))
    out = {"losses": hist["text_loss"], "restored_ok": restored_ok,
           "local_shape": tuple(mine["layers"]["wq"].shape),
           "grad_norm": _sharded_grad_norm(cfg, params, shards, local, tc)}
    if rank == 0:
        out["params"] = {k: v.numpy() for k, v in _flat(trained).items()}
    return out


def _sharded_grad_norm(cfg, params, shards, examples, tc) -> float:
    """The clipping norm of the first step's gradients, as the sharded
    trainer computes it."""
    from project_morpheus_tpu_torch.model.bridge import group_layer_params, tree_leaves
    from project_morpheus_tpu_torch.training.data import pad_collate
    from project_morpheus_tpu_torch.training.pretrain import causal_lm_loss

    grouped = group_layer_params(shards.cut(params), cfg.num_layers)
    leaves = tree_leaves(grouped)
    for p in leaves:
        p.requires_grad_(True)
    loss = causal_lm_loss(grouped, pad_collate(examples, max_len=tc.seq_len), cfg, shard=shards)
    grads = shards.reduce_grads(torch.autograd.grad(loss, leaves), grouped)
    return float(shards.global_norm_fn(grouped)(grads))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach()
    return out


def decode(inp, rank):
    from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy
    from project_morpheus_tpu_torch.model.config import LlamaConfig
    from project_morpheus_tpu_torch.model.llama import (
        init_kv_cache,
        llama_decode_step,
        llama_prefill_chunk,
    )
    from project_morpheus_tpu_torch.parallel import make_mesh
    from project_morpheus_tpu_torch.parallel.tensor import tensor_parallel

    cfg = LlamaConfig(**inp["cfg"])
    mesh = make_mesh(1, inp["model"], device="cpu")
    tp = tensor_parallel(mesh)
    params = params_from_jax_numpy(inp["params"], "cpu", mesh=mesh, mode="tp")
    cache = init_kv_cache(tp.local_cfg(cfg), inp["batch"], inp["max_len"], inp["cache_dtype"])
    prefill = []
    for slot, prompt in enumerate(inp["prompts"]):
        toks = torch.zeros(inp["bucket"], dtype=torch.int32)
        toks[:len(prompt)] = torch.tensor(prompt)
        prefill.append(llama_prefill_chunk(params, toks, cfg, cache, 0, slot, len(prompt),
                                           hist_bucket=inp["max_len"], tp=tp))
    lengths = torch.tensor([len(p) for p in inp["prompts"]], dtype=torch.int32)
    tokens = torch.tensor(inp["next_tokens"], dtype=torch.int32)
    steps = []
    for _ in range(inp["steps"]):
        logits = llama_decode_step(params, tokens, cfg, cache, lengths, tp=tp)
        steps.append(logits.numpy())
        tokens = logits[:, :cfg.vocab_size].argmax(-1).int()
        lengths = lengths + 1
    return {"prefill": torch.stack(prefill).numpy(), "steps": steps,
            "wq_local": tuple(params["layers"]["wq"]["q"].shape if isinstance(
                params["layers"]["wq"], dict) else params["layers"]["wq"].shape)}


def engine(inp, rank):
    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
    from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy
    from project_morpheus_tpu_torch.model.config import LlamaConfig
    from project_morpheus_tpu_torch.model.sampling import SamplingParams
    from project_morpheus_tpu_torch.parallel import make_mesh

    cfg = LlamaConfig(**inp["cfg"])
    mesh = make_mesh(inp["data"], inp["model"], device="cpu")
    params = params_from_jax_numpy(inp["params"], "cpu")

    async def go():
        eng = OrpheusEngine(params, cfg, EngineConfig(**inp["ecfg"]), mesh=mesh, seed=3,
                            device="cpu")
        reqs = [await eng.submit(p, SamplingParams(**s)) for p, s in inp["requests"]]
        traces = [[t async for t in r.tokens()] for r in reqs]
        await eng.close()
        return traces, "wqkv" in eng.params["layers"], tuple(eng.cache["k"].shape)

    traces, fused, cache_shape = asyncio.run(go())
    return {"traces": traces, "fused": fused, "cache_shape": cache_shape}


def main() -> int:
    scenario, inp_path, out_dir = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
    inp = pickle.loads(inp_path.read_bytes())
    rank = _setup(str(out_dir / "store"))
    out = {"train": train, "decode": decode, "engine": engine}[scenario](inp, rank)
    out["rank"] = rank
    (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def launch(tmp_path: Path, scenario: str, inp: dict, world: int, timeout: float = 150.0):
    """Run ``world`` ranks of ``scenario`` and return their results by rank.
    Each call gets its own ``file://`` store under ``tmp_path``, so
    concurrent tests never share a rendezvous; a rank that fails, or a run
    past ``timeout``, kills every rank and fails the test at once."""
    import subprocess
    import time

    import tempfile

    out = Path(tempfile.mkdtemp(prefix=f"mp_{scenario}_", dir=tmp_path))
    (out / "in.pkl").write_bytes(pickle.dumps(inp))
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env.update(PYTHONPATH=str(repo), OMP_NUM_THREADS="1", WORLD_SIZE=str(world))
    logs = [open(out / f"rank{r}.log", "wb") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), scenario, str(out / "in.pkl"), str(out)],
        env={**env, "RANK": str(r)}, stdout=logs[r], stderr=subprocess.STDOUT, cwd=repo)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"{scenario} rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"{scenario}: ranks still running after {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        # the rank that raised, not one killed after it
        r = next((r for r in bad if procs[r].returncode > 0), bad[0] if bad else 0)
        raise AssertionError(f"{failed or f'{scenario} rank {r} failed'}:\n"
                             f"{(out / f'rank{r}.log').read_text(errors='replace')[-4000:]}")
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(world)]


if __name__ == "__main__":
    sys.exit(main())
