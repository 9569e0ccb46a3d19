"""The port's ``parallel`` package against the JAX package's: the sharding
specs of every mode, leaf for leaf; ``shardings_like`` on int8 and fused
leaves; each rank's ``shard_params`` block against the shard JAX places on
the device at the same mesh coordinates; the process-group rules; and, in
two gloo processes (``tests/torch_multiproc_worker.py``), tensor-parallel
prefill and decode against JAX's unsharded ``llama_decode_step``, and TP
and DP engines against JAX's unsharded engine."""
import asyncio
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model import init_llama_params as jax_init
from project_morpheus_tpu.model import llama as jl
from project_morpheus_tpu.model.quant import fuse_layer_weights as jax_fuse
from project_morpheus_tpu.model.quant import quantize_params_int8 as jax_quant
from project_morpheus_tpu import parallel as jpar
from project_morpheus_tpu_torch import parallel as tpar
from project_morpheus_tpu_torch.model.config import LlamaConfig
from project_morpheus_tpu_torch.parallel.mesh import Mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_multiproc_worker import launch  # noqa: E402

MODES = ("tp", "fsdp", "fsdp_tp", "replicated")


def _spec(ns):
    """A JAX NamedSharding's spec as the port's tuple (padded with None)."""
    return tuple(ns.spec)


def _port_mesh(data, model, d=0, m=0):
    return Mesh({"data": data, "model": model}, {"data": d, "model": m},
                torch.device("cpu"), None)


def _zip_specs(port, jaxs, path=""):
    if isinstance(port, dict):
        assert set(port) == set(jaxs), path
        for k in port:
            _zip_specs(port[k], jaxs[k], f"{path}.{k}")
        return
    want = _spec(jaxs)
    got = port.spec + (None,) * (len(want) - len(port.spec))
    assert got == want + (None,) * (len(got) - len(want)), f"{path}: {port.spec} vs {want}"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tied", [True, False])
def test_param_shardings_equal_jax(mode, tied):
    jmesh = jpar.make_mesh(model=2, devices=jax.devices()[:4])
    cfg = dict(tie_embeddings=tied)
    _zip_specs(tpar.param_shardings(LlamaConfig(**cfg), _port_mesh(2, 2), mode),
               jpar.param_shardings(JaxLlamaConfig(**cfg), jmesh, mode))
    with pytest.raises(ValueError, match="unknown sharding mode"):
        tpar.param_shardings(LlamaConfig(), _port_mesh(2, 2), "zero3")


def test_state_and_batch_shardings_equal_jax():
    jmesh = jpar.make_mesh(model=2, devices=jax.devices()[:4])
    pm = _port_mesh(2, 2)
    for q in (False, True):
        _zip_specs(tpar.kv_cache_shardings(pm, q), jpar.kv_cache_shardings(jmesh, q))
        for ring in (False, True):
            _zip_specs(tpar.engine_state_shardings(pm, q, ring),
                       jpar.engine_state_shardings(jmesh, q, ring))
    assert tpar.batch_shardings(pm).spec == _spec(jpar.batch_shardings(jmesh))


@pytest.mark.parametrize("fused", [False, True])
def test_shardings_like_quantized_and_fused_equal_jax(fused):
    jcfg = JaxLlamaConfig.tiny_vocab()
    jp = jax_quant(jax_init(jcfg, jax.random.key(0), dtype=jnp.float32))
    if fused:
        jp = jax_fuse(jp)
    np_params = jax.tree.map(np.asarray, jp)
    jmesh = jpar.make_mesh(model=2, devices=jax.devices()[:4])
    for mode in MODES:
        _zip_specs(tpar.shardings_like(np_params, tpar.param_shardings(
            LlamaConfig.tiny_vocab(), _port_mesh(2, 2), mode)),
            jpar.shardings_like(jp, jpar.param_shardings(jcfg, jmesh, mode)))


@pytest.mark.parametrize("mode", MODES)
def test_shard_params_blocks_equal_jax_device_shards(mode):
    """The block ``shard_params`` cuts for mesh coordinate (d, m) is the
    shard JAX puts on the device at (d, m), for plain and int8 leaves."""
    jcfg = JaxLlamaConfig.tiny_vocab()
    jp = jax_quant(jax_init(jcfg, jax.random.key(1), dtype=jnp.float32))
    jp["lm_head"] = jnp.zeros((jcfg.hidden_size, jcfg.padded_vocab), jnp.float32) + 0.5
    jcfg = JaxLlamaConfig(**{**jcfg.__dict__, "tie_embeddings": False})
    jmesh = jpar.make_mesh(model=2, devices=jax.devices()[:4])
    placed = jax.device_put(jp, jpar.shardings_like(jp, jpar.param_shardings(jcfg, jmesh, mode)))
    np_params = jax.tree.map(np.asarray, jp)
    grid = jmesh.devices
    for d in range(2):
        for m in range(2):
            mine = tpar.shard_params(np_params, _port_mesh(2, 2, d, m), mode)
            dev = grid[d, m]
            for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
                shard = next(s for s in leaf.addressable_shards if s.device == dev)
                node = mine
                for key in path:
                    node = node[key.key]
                np.testing.assert_array_equal(node, np.asarray(shard.data), err_msg=str(path))


def test_shard_params_torch_leaves_and_bridge():
    from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy

    jp = jax_init(JaxLlamaConfig.tiny_vocab(), jax.random.key(2), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    full = params_from_jax_numpy(np_params)
    mesh = _port_mesh(1, 2, 0, 1)
    a = tpar.shard_params(full, mesh, "tp")
    b = params_from_jax_numpy(np_params, mesh=mesh, mode="tp")
    assert a["layers"]["wq"].shape == (2, 64, 32) and a["embed"].shape == (512, 64)
    for k in ("wq", "wo"):
        assert torch.equal(a["layers"][k], b["layers"][k])
    assert torch.equal(a["layers"]["wq"], full["layers"]["wq"][:, :, 32:])
    assert torch.equal(a["layers"]["wo"], full["layers"]["wo"][:, 32:, :])
    assert a["layers"]["wq"].is_contiguous()
    with pytest.raises(ValueError, match="does not split"):
        tpar.shard_params(full, _port_mesh(1, 3, 0, 0), "tp")


def test_mesh_helpers_and_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tpar.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert tpar.mesh_shape_for(8, 2) == jpar.mesh_shape_for(8, 2) == (4, 2)
    with pytest.raises(ValueError, match="tp=3 does not divide device count 8"):
        tpar.mesh_shape_for(8, 3)
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("model") is None
    with pytest.raises(ValueError, match=r"mesh 1x2 != 1 devices"):
        tpar.make_mesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        tpar.make_multihost_mesh(data=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        tpar.make_mesh()  # no group, no device, no card: never a silent CPU mesh
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="incomplete process-group settings"):
        tpar.initialize_distributed(device="cpu")


def test_backend_rule():
    assert tpar.choose_backend("cpu", 4, 0) == "gloo"
    assert tpar.choose_backend("cuda", 1, 1) == "nccl"
    assert tpar.choose_backend("cuda", 4, 4) == "nccl"
    assert tpar.choose_backend("cuda", 2, 1) == "gloo"  # ranks share the card
    assert tpar.choose_backend("cuda", 2, 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="nccl needs a card for each rank"):
        tpar.choose_backend("cuda", 2, 1, "nccl")
    with pytest.raises(ValueError, match="only gloo"):
        tpar.choose_backend("cpu", 1, 0, "nccl")


def test_public_names_cover_jax():
    assert set(jpar.__all__) <= set(tpar.__all__)


# ------------------------------------------------------- two gloo processes


@pytest.mark.parametrize("kind,cache", [("int8", torch.int8), ("plain", torch.float32)])
def test_two_process_tp_prefill_and_decode_match_jax(tmp_path, kind, cache):
    cfg = JaxLlamaConfig.tiny_vocab()
    jp = jax_init(cfg, jax.random.key(3), dtype=jnp.float32)
    if kind == "int8":
        jp = jax_quant(jp)
    prompts = [[5, 6, 7, 9, 11], [40, 41, 42]]
    B, S, bucket = 2, 64, 16
    jc = jl.init_kv_cache(cfg, B, S, jnp.int8 if cache == torch.int8 else jnp.float32)
    jpre = []
    for slot, p in enumerate(prompts):
        toks = np.zeros(bucket, np.int32)
        toks[:len(p)] = p
        lg, jc = jl.llama_prefill_chunk(jp, jnp.asarray(toks), cfg, jc, jnp.asarray(0),
                                        jnp.asarray(slot), jnp.asarray(len(p)), hist_bucket=S)
        jpre.append(np.asarray(lg))
    lengths = jnp.asarray([len(p) for p in prompts], jnp.int32)
    tokens = jnp.asarray([3, 4], jnp.int32)
    jsteps = []
    for _ in range(3):
        lg, jc = jl.llama_decode_step(jp, tokens, cfg, jc, lengths)
        jsteps.append(np.asarray(lg))
        tokens = jnp.argmax(lg[:, :cfg.vocab_size], -1).astype(jnp.int32)
        lengths = lengths + 1
    inp = {"cfg": cfg.__dict__, "params": jax.tree.map(np.asarray, jp), "model": 2,
           "batch": B, "max_len": S, "cache_dtype": cache, "bucket": bucket,
           "prompts": prompts, "next_tokens": [3, 4], "steps": 3}
    results = launch(tmp_path, "decode", inp, 2)
    assert results[0]["wq_local"] == (cfg.num_layers, cfg.hidden_size,
                                      cfg.num_heads * cfg.head_dim // 2)
    for r in results:
        # fp32 weights (int8 dequantised in fp32): the row-split partial
        # sums add in another order than the unsharded dot products
        np.testing.assert_allclose(r["prefill"], np.stack(jpre), rtol=1e-3, atol=1e-3)
        for got, want in zip(r["steps"], jsteps, strict=True):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(results[0]["steps"][-1], results[1]["steps"][-1])


ENGINE_CFG = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16,), default_stop_ids=())
GREEDY = [([5, 6, 7], dict(temperature=0.0, max_tokens=6, stop_token_ids=())),
          ([9, 10, 11, 12, 13], dict(temperature=0.0, max_tokens=8, stop_token_ids=()))]
SAMPLED = [([5, 6, 8], dict(temperature=0.8, top_p=0.9, max_tokens=8, seed=11,
                            stop_token_ids=()))]


@pytest.fixture(scope="module")
def engine_refs():
    """JAX's unsharded int8 engine (greedy requests) and the port's
    unsharded engine (all requests: its sampling bits are its own)."""
    from project_morpheus_tpu.engine import EngineConfig as JEC
    from project_morpheus_tpu.engine import OrpheusEngine as JEngine
    from project_morpheus_tpu.model.sampling import SamplingParams as JSP
    from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
    from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy
    from project_morpheus_tpu_torch.model.sampling import SamplingParams

    cfg = JaxLlamaConfig.tiny_vocab()
    jp = jax_quant(jax_init(cfg, jax.random.key(5), dtype=jnp.float32))

    async def run(eng, sp_cls, reqs):
        handles = [await eng.submit(p, sp_cls(**s)) for p, s in reqs]
        out = [[t async for t in h.tokens()] for h in handles]
        await eng.close()
        return out

    jtraces = asyncio.run(run(JEngine(jp, cfg, JEC(**ENGINE_CFG), seed=3), JSP, GREEDY))
    np_params = jax.tree.map(np.asarray, jp)
    ttraces = asyncio.run(run(OrpheusEngine(params_from_jax_numpy(np_params), LlamaConfig.tiny_vocab(),
                                            EngineConfig(**ENGINE_CFG), seed=3, device="cpu"),
                              SamplingParams, GREEDY + SAMPLED))
    assert ttraces[:2] == jtraces
    return cfg, np_params, jtraces, ttraces


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_two_process_engines_match_unsharded(tmp_path, engine_refs, data, model):
    """TP (1 x 2) and DP (2 x 1) engines: greedy traces equal JAX's
    unsharded engine, the seeded sampled trace the port's unsharded one;
    three requests on two slots, so one waits for a freed slot."""
    cfg, np_params, jtraces, ttraces = engine_refs
    inp = {"cfg": cfg.__dict__, "params": np_params, "data": data, "model": model,
           "ecfg": ENGINE_CFG, "requests": GREEDY + SAMPLED}
    results = launch(tmp_path, "engine", inp, 2)
    for r in results:
        assert r["traces"][:2] == jtraces, f"rank {r['rank']}: {r['traces']} vs JAX {jtraces}"
        assert r["traces"] == ttraces
        assert r["fused"] is (model == 1)
        # bf16 cache (L, slots, KV, S, HD): this rank's slots and kv heads
        assert r["cache_shape"] == (cfg.num_layers, 2 // data, cfg.num_kv_heads // model,
                                    64, cfg.head_dim)


def test_two_process_tp_bf16_step_matches_tp_arithmetic():
    """``chip_smoke.py`` phase 9 (c) on the CPU at a small width, bf16
    int8 weights and KV, tp = 2: one decode step's logits against the
    unsharded step computed at the ranks' shapes and sums (the check must
    hold), a planted fault (rank 1's wo scales x1.01) must exceed the same
    limit, and both ranks' greedy traces agree."""
    import chip_smoke
    from project_morpheus_tpu_torch.model.config import ORPHEUS_VOCAB

    cfg = LlamaConfig(vocab_size=ORPHEUS_VOCAB, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
                      max_seq_len=2048, rope_scaling_factor=1.0)
    records = [{}, {}, {}]
    r0 = chip_smoke.phase_tp2("cpu", records, device="cpu", cfg=cfg, timeout_s=240)
    # the same arithmetic in the same order on the CPU: a tenth of the fault at most
    assert r0["tp_ref_err"] <= r0["fault_err"] / 10, r0
    assert r0["fault_err"] > chip_smoke.MESH_TP_REF_TOL

