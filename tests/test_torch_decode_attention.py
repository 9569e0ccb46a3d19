"""The port's decode-attention wrappers against the JAX package's entry
points.  On the CPU each wrapper runs its plain twin; the JAX side runs
its Pallas kernels in interpret mode where they take the shape (kernel 1
and the slot kernel) and its dense oracle otherwise (the layered entry).

fp32 on both sides: outputs agree to 2e-4 (abs and rel), the tolerance of
the JAX package's own kernel tests.  A slot of length 0 yields zeros, as
the Pallas kernels give (the dense oracle gives the mean of V there).

The CUDA kernels are held against these twins on the card by
``tests/test_torch_cuda.py``, which imports no JAX."""
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_int8_slots as jax_slots,
    decode_attention_layered as jax_layered,
)
from project_morpheus_tpu_torch.engine import EngineConfig, OrpheusEngine
from project_morpheus_tpu_torch.model import LlamaConfig

TOL = dict(rtol=2e-4, atol=2e-4)

# the package exports the function under the module's name
da = importlib.import_module("project_morpheus_tpu_torch.ops.decode_attention")


def _t(x):
    return torch.from_numpy(np.array(x))


def _mk(B=2, S=512, KV=2, G=3, HD=128, seed=0):
    rng = np.random.default_rng(seed)
    H = KV * G
    return (rng.standard_normal((B, H, HD)).astype(np.float32),
            rng.standard_normal((B, KV, S, HD)).astype(np.float32),
            rng.standard_normal((B, KV, S, HD)).astype(np.float32))


@pytest.mark.parametrize("lengths", [[512, 512], [100, 300], [1, 257], [0, 130]])
def test_single_layer_matches_pallas_kernel(lengths):
    q, k, v = _mk()
    lens = np.asarray(lengths, np.int32)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lens), block_s=128, interpret=True)
    got = da.decode_attention(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_single_layer_tail_garbage_ignored():
    q, k, v = _mk(B=1, seed=3)
    lens = _t(np.asarray([130], np.int32))
    base = da.decode_attention(_t(q), _t(k), _t(v), lens)
    k[:, :, 130:] = 1e9
    v[:, :, 130:] = -1e9
    got = da.decode_attention(_t(q), _t(k), _t(v), lens)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-6, atol=1e-6)


# (head_dim, group): the benchmark's trunks, SmolLM2-1.7B (64, 1) and
# Mistral-7B (128, 4); the Orpheus shapes (128, 3) and (64, 4); and (128, 8),
# which no kernel takes (the twins take any shape)
HEAD_SHAPES = [(64, 1), (128, 4), (128, 3), (64, 4), (128, 8)]


def _int8_layered(seed=0, L=2, B=3, KV=2, S=256, HD=128, G=3):
    rng = np.random.default_rng(seed)
    kf = rng.normal(size=(L, B, KV, S, HD)).astype(np.float32)
    vf = rng.normal(size=(L, B, KV, S, HD)).astype(np.float32)
    ks = (np.abs(kf).max(-1) / 127.0 + 1e-8).astype(np.float32)
    vs = (np.abs(vf).max(-1) / 127.0 + 1e-8).astype(np.float32)
    k8 = np.clip(np.round(kf / ks[..., None]), -127, 127).astype(np.int8)
    v8 = np.clip(np.round(vf / vs[..., None]), -127, 127).astype(np.int8)
    q = rng.normal(size=(B, KV * G, HD)).astype(np.float32)
    return q, kf, vf, k8, v8, ks, vs


@pytest.mark.parametrize("HD,G", HEAD_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
def test_layered_matches_jax_with_length_zero(quant, HD, G):
    q, kf, vf, k8, v8, ks, vs = _int8_layered(HD=HD, G=G)
    lens = np.asarray([0, 100, 256], np.int32)
    if quant:
        want = jax_layered(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lens),
                           jnp.asarray(1), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                           interpret=True)
        got = da.decode_attention_layered(_t(q), _t(k8), _t(v8), _t(lens), 1,
                                          k_scale=_t(ks), v_scale=_t(vs))
    else:
        want = jax_layered(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(lens),
                           jnp.asarray(1), interpret=True)
        got = da.decode_attention_layered(_t(q), _t(kf), _t(vf), _t(lens), 1)
    np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:], **TOL)
    assert np.all(got.numpy()[0] == 0.0)


@pytest.mark.parametrize("HD,G", HEAD_SHAPES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths", [[63, 64, 65], [127, 128, 129], [255, 256, 1]])
def test_layered_matches_jax_at_tile_edges(lengths, quant, HD, G):
    q, kf, vf, k8, v8, ks, vs = _int8_layered(seed=1, HD=HD, G=G)
    lens = np.asarray(lengths, np.int32)
    if quant:
        want = jax_layered(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lens),
                           jnp.asarray(0), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                           interpret=True)
        got = da.decode_attention_layered(_t(q), _t(k8), _t(v8), _t(lens), 0,
                                          k_scale=_t(ks), v_scale=_t(vs))
    else:
        want = jax_layered(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(lens),
                           jnp.asarray(0), interpret=True)
        got = da.decode_attention_layered(_t(q), _t(kf), _t(vf), _t(lens), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mk_slots(L=2, B=3, S=256, KV=2, HD=32, H=6, seed=0):
    rng = np.random.default_rng(seed)
    k8 = rng.integers(-127, 128, (L, B, S, KV * HD), dtype=np.int8)
    v8 = rng.integers(-127, 128, (L, B, S, KV * HD), dtype=np.int8)
    sc = rng.uniform(0.005, 0.02, (L, B, S, 2 * KV)).astype(np.float32)
    q = rng.standard_normal((B, H, HD)).astype(np.float32)
    return q, k8, v8, sc


def _jax_slots(q, k8, v8, sc, lens, layer):
    return np.asarray(jax_slots(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                                jnp.asarray(sc), jnp.asarray(lens), jnp.asarray(layer),
                                block_s=64, interpret=True))


# the CUDA kernels stream 128-position tiles, 16 positions a warp: lengths
# on both sides of those edges, and of the capacity S = 256
@pytest.mark.parametrize("HD,G", HEAD_SHAPES)
@pytest.mark.parametrize("lengths", [[256, 256, 256], [5, 128, 250], [0, 256, 17],
                                     [63, 64, 65], [127, 128, 129], [255, 192, 193]])
def test_int8_slots_matches_pallas_kernel(lengths, HD, G):
    q, k8, v8, sc = _mk_slots(HD=HD, H=2 * G)
    lens = np.asarray(lengths, np.int32)
    for layer in (0, 1):
        got = da.decode_attention_int8_slots(_t(q), _t(k8), _t(v8), _t(sc), _t(lens), layer)
        np.testing.assert_allclose(got.numpy(), _jax_slots(q, k8, v8, sc, lens, layer), **TOL)


def test_int8_slots_tail_garbage_ignored():
    q, k8, v8, sc = _mk_slots(seed=3)
    lens = np.asarray([100, 64, 200], np.int32)
    base = da.decode_attention_int8_slots(_t(q), _t(k8), _t(v8), _t(sc), _t(lens), 0)
    k8[0, 0, 100:] = 127
    v8[0, 0, 100:] = -127
    sc[0, 0, 100:] = 1.0
    got = da.decode_attention_int8_slots(_t(q), _t(k8), _t(v8), _t(sc), _t(lens), 0)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _jax_slots(q, k8, v8, sc, lens, 0), **TOL)


@pytest.mark.parametrize("entry", ["int8_slots", "layered"])
def test_twin_clamps_lengths_past_capacity(entry):
    """A length past the capacity S attends the whole slot, as at S."""
    over, at = _t(np.asarray([256 + 100, 5, 256], np.int32)), _t(np.asarray([256, 5, 256], np.int32))
    if entry == "int8_slots":
        q, k8, v8, sc = _mk_slots(seed=4)
        run = lambda lens: da.decode_attention_int8_slots(_t(q), _t(k8), _t(v8), _t(sc), lens, 1)
    else:
        q, _, _, k8, v8, ks, vs = _int8_layered(seed=4)
        run = lambda lens: da.decode_attention_layered(_t(q), _t(k8), _t(v8), lens, 1,
                                                       k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_array_equal(run(over).numpy(), run(at).numpy())


def test_wrappers_count_only_kernel_launches():
    q, k8, v8, sc = _mk_slots()
    da.reset_launch_counts()
    da.decode_attention_int8_slots(_t(q), _t(k8), _t(v8), _t(sc),
                                   _t(np.asarray([1, 2, 3], np.int32)), 0)
    assert da.LAUNCHES == {"decode_attention_layered": 0, "decode_attention_int8_slots": 0}


# Lengths on both sides of the kernels' split edges (SPLIT_LEN = 512
# positions) and at the capacity, each entry against the JAX package's (past
# the capacity the port clamps where the JAX slot kernel does not:
# test_twin_clamps_lengths_past_capacity)
@pytest.mark.parametrize("HD,G", HEAD_SHAPES)
@pytest.mark.parametrize("entry", ["layered", "layered_int8", "int8_slots"])
def test_twins_match_reference_at_trunk_shapes(HD, G, entry):
    S, KV = 2 * da.SPLIT_LEN, 2
    lens = np.asarray([1, 511, 512, 513, 1000, S], np.int32)
    q, kf, vf, k8, v8, ks, vs = _int8_layered(seed=HD + G, B=len(lens), KV=KV, S=S, HD=HD, G=G)
    if entry == "layered":
        got = da.decode_attention_layered(_t(q), _t(kf), _t(vf), _t(lens), 1)
        want = jax_layered(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(lens),
                           jnp.asarray(1), interpret=True)
    elif entry == "layered_int8":
        got = da.decode_attention_layered(_t(q), _t(k8), _t(v8), _t(lens), 1,
                                          k_scale=_t(ks), v_scale=_t(vs))
        want = jax_layered(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lens),
                           jnp.asarray(1), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                           interpret=True)
    else:  # the same values in the flat position-major layout
        L, B = k8.shape[:2]
        flat = lambda x: x.transpose(0, 1, 3, 2, 4).reshape(L, B, S, KV * HD)  # noqa: E731
        sc = np.ascontiguousarray(np.concatenate([ks, vs], axis=2).transpose(0, 1, 3, 2))
        got = da.decode_attention_int8_slots(_t(q), _t(flat(k8)), _t(flat(v8)), _t(sc),
                                             _t(lens), 1)
        want = _jax_slots(q, flat(k8), flat(v8), sc, lens, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_decode_supported_names_the_instantiated_shapes():
    """The predicate is true exactly at the (head_dim, group) pairs that
    ``launch_flash_decode`` instantiates, head dims 64 and 128 with groups
    of 1 to 4 (the card's tests run each), and the wrappers' shape check
    raises for any other before a launch."""
    for hd in (64, 128):
        for g in (1, 2, 3, 4):
            assert da.flash_decode_supported(hd, g)
    for hd, g in [(128, 8), (64, 5), (128, 0), (96, 4), (32, 3), (256, 1)]:
        assert not da.flash_decode_supported(hd, g)
    lens = torch.zeros(2, dtype=torch.int32)
    da._check_common(torch.zeros(2, 4, 64, dtype=torch.bfloat16), lens, 2, 4)
    with pytest.raises(ValueError, match="no kernel for"):
        da._check_common(torch.zeros(2, 16, 128, dtype=torch.bfloat16), lens, 2, 2)


def _resolve(bucket=1024, *, attn_impl="auto", device="cuda", mesh=None, cache="bfloat16",
             heads=32, kv_heads=32, head_dim=64):
    """``OrpheusEngine._attn_for`` on a stub engine's state (no engine is
    built, so a CUDA device type needs no card)."""
    stub = types.SimpleNamespace(
        attn_impl=attn_impl, device=torch.device(device), mesh=mesh,
        ecfg=EngineConfig(cache_dtype=cache, attn_impl=attn_impl),
        cfg=LlamaConfig(vocab_size=1024, hidden_size=2048, intermediate_size=8192,
                        num_layers=2, num_heads=heads, num_kv_heads=kv_heads,
                        head_dim=head_dim))
    return OrpheusEngine._attn_for(stub, bucket)


def test_auto_sends_bf16_caches_on_one_card_to_the_kernel():
    smol, mistral = dict(heads=32, kv_heads=32, head_dim=64), dict(heads=32, kv_heads=8,
                                                                   head_dim=128)
    for shape in (smol, mistral):
        for bucket in (None, 256, 1024, 8192):  # a bf16 cache at any bucket
            assert _resolve(bucket, **shape) == "kernel"
        assert _resolve(device="cpu", **shape) == "dense"
        assert _resolve(mesh=object(), **shape) == "dense"
        assert _resolve(attn_impl="dense", **shape) == "dense"
        assert _resolve(attn_impl="kernel", device="cpu", **shape) == "kernel"
        # int8 caches keep pallas_min_bucket (2048)
        assert _resolve(1024, cache="int8", **shape) == "dense"
        assert _resolve(2048, cache="int8", **shape) == "kernel"
        assert _resolve(None, cache="int8", **shape) == "kernel"  # max_seq_len 2048
        assert _resolve(cache="float32", **shape) == "dense"
    # the shape plays no part: a shape no kernel takes (G = 8) resolves to
    # the kernel as any other, whose wrapper then raises
    for cache, bucket in (("bfloat16", 1024), ("int8", 4096)):
        assert _resolve(bucket, cache=cache, heads=64, kv_heads=8, head_dim=128) == "kernel"
