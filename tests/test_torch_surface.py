"""The JAX package's last public surface in the port, each piece against its
JAX twin on the CPU, and the two packages' names held to one another.

- the windowed decoder's batched path (``HOP_SAMPLES``,
  ``decode_windows_batched``, ``plan_push`` / ``plan_flush``): windows
  equal exactly (integers); int16 PCM within 2 LSB, the truncation of a
  last-bit difference, as in ``test_torch_snac.py``; and the batched hops
  of a stream equal to the ones ``push_tokens`` + ``flush`` give, within
  the same 2 LSB;
- the sampler state (``init_sampler_state``, ``note_tokens``,
  ``reset_slots``) and ``dequantize_weight``: exactly equal;
- ``decode_attention_reference``, JAX's dense oracle: fp32 within 2e-4
  (abs and rel), the tolerance of ``test_torch_decode_attention.py``;
  bf16 within 1e-2 |ref| + 2e-3, the repo's bound for a bf16 output
  (``chip_smoke.check_close``);
- every name of the JAX ``codec``, ``model`` and ``ops`` ``__all__``
  imports from the port's same subpackage, and every public top-level name
  of every JAX module has a same-named counterpart in the port's same
  module, unless ``project_morpheus_tpu_torch/name_map.py`` maps it."""
import ast
import importlib
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.codec import SNACConfig as JaxSNACConfig
from project_morpheus_tpu.codec import StreamingSnacDecoder as JaxDecoder
from project_morpheus_tpu.codec import init_snac_params as jax_snac_init
from project_morpheus_tpu.codec.streaming import HOP_SAMPLES as JAX_HOP_SAMPLES
from project_morpheus_tpu.codec.streaming import decode_windows_batched as jax_batched
from project_morpheus_tpu.model import quant as jax_quant
from project_morpheus_tpu.model import sampling as jax_sampling
from project_morpheus_tpu.ops.decode_attention import decode_attention_reference as jax_reference
from project_morpheus_tpu_torch import name_map
from project_morpheus_tpu_torch.codec import (
    HOP_SAMPLES,
    SNACConfig,
    StreamingSnacDecoder,
    decode_windows_batched,
    init_snac_params,
)
from project_morpheus_tpu_torch.model import quant, sampling
from project_morpheus_tpu_torch.ops import decode_attention_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "project_morpheus_tpu", ROOT / "project_morpheus_tpu_torch"


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


@pytest.fixture(scope="module")
def snac():
    cfg = SNACConfig.tiny()
    return cfg, jax_snac_init(JaxSNACConfig.tiny(), seed=3), init_snac_params(cfg, 3, "cpu")


# ------------------------------------------------- batched window decode


def test_hop_samples():
    assert HOP_SAMPLES == JAX_HOP_SAMPLES == SNACConfig.snac_24khz().frame_samples


@pytest.mark.parametrize("emit", ["hop", "whole"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_decode_windows_batched_matches_jax(snac, emit, as_tensor):
    cfg, jparams, tparams = snac
    hop = cfg.frame_samples
    lo, hi = (4 * hop, 5 * hop) if emit == "hop" else (0, 7 * hop)
    windows = np.random.default_rng(7).integers(0, 4096, (3, 7 * 7)).astype(np.int32)
    want = jax_batched(jparams, jnp.asarray(windows), cfg=JaxSNACConfig.tiny(),
                       emit_lo=lo, emit_hi=hi)
    got = decode_windows_batched(tparams, torch.from_numpy(windows) if as_tensor else windows,
                                 cfg=cfg, emit_lo=lo, emit_hi=hi)
    assert got.dtype == torch.int16 and tuple(got.shape) == (3, hi - lo) == want.shape
    assert _lsb(got.numpy(), want) <= 2


def _plan(dec, trace, piece):
    """Windows per plan_push call, then plan_flush's."""
    rounds = [dec.plan_push(trace[i:i + piece]) for i in range(0, len(trace), piece)]
    return rounds + [dec.plan_flush()]


# 10 whole frames and a 3-code partial tail
TRACE = np.random.default_rng(11).integers(0, 4096, 7 * 10 + 3).tolist()


@pytest.mark.parametrize("lookahead", [0, 2])
@pytest.mark.parametrize("piece", [1, 5, 7])
def test_plan_windows_match_jax(snac, piece, lookahead):
    cfg, jparams, tparams = snac
    want = _plan(JaxDecoder(jparams, JaxSNACConfig.tiny(), lookahead_frames=lookahead),
                 TRACE, piece)
    got = _plan(StreamingSnacDecoder(tparams, cfg, lookahead_frames=lookahead), TRACE, piece)
    assert [len(r) for r in got] == [len(r) for r in want]
    assert sum(len(r) for r in got) == 11 and got[-1]  # the tail is padded to a frame
    for g, w in zip(sum(got, []), sum(want, [])):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("lookahead", [0, 2])
def test_batched_hops_equal_push_and_flush(snac, lookahead):
    """Three streams of different lengths planned round by round, each
    round's windows from all streams decoded in one call: every stream's
    hops equal those of its own decoder's push_tokens + flush."""
    cfg, _, tparams = snac
    hop = cfg.frame_samples
    rng = np.random.default_rng(5)
    traces = [rng.integers(0, 4096, n).tolist() for n in (7 * 9 + 3, 7 * 6, 7 * 4 + 5)]
    planners = [StreamingSnacDecoder(tparams, cfg, lookahead_frames=lookahead) for _ in traces]
    batched = [[] for _ in traces]
    for start in range(0, max(map(len, traces)) + 7, 7):
        final = start >= max(map(len, traces))
        owned = [(s, w) for s, (p, t) in enumerate(zip(planners, traces))
                 for w in (p.plan_flush() if final else p.plan_push(t[start:start + 7]))]
        if owned:
            pcm = decode_windows_batched(tparams, np.stack([w for _, w in owned]), cfg=cfg,
                                         emit_lo=4 * hop, emit_hi=5 * hop).numpy()
            for (s, _), row in zip(owned, pcm):
                batched[s].append(row)
    for trace, hops in zip(traces, batched):
        ref = StreamingSnacDecoder(tparams, cfg, lookahead_frames=lookahead)
        want = ref.push_tokens(trace) + ref.flush()
        assert len(hops) == len(want) == -(-len(trace) // 7)
        for h, w in zip(hops, want):
            assert h.shape == w.shape == (hop,) and _lsb(h, w) <= 2


def test_plan_needs_native_mode(snac):
    cfg, _, tparams = snac
    dec = StreamingSnacDecoder(tparams, cfg, mode="parity")
    with pytest.raises(ValueError, match="native"):
        dec.plan_push([1] * 7)
    with pytest.raises(ValueError, match="native"):
        dec.plan_flush()


# --------------------------------------------------------- sampler state


def _presence(state):
    return np.asarray(state["presence"])


@pytest.mark.parametrize("case", ["1d", "2d", "2d_mask"])
def test_sampler_state_matches_jax(case):
    """Rows hold repeated tokens, but never one both masked in and out
    (the order JAX's scatter writes those in is not defined)."""
    rng = np.random.default_rng(2)
    B, Vp = 4, 40
    tokens = rng.integers(0, Vp, (B,) if case == "1d" else (B, 6)).astype(np.int32)
    tokens[..., -1] = tokens[..., 0]  # a duplicate in every row
    mask = None
    if case == "2d_mask":
        mask = rng.random(tokens.shape) < 0.6
        mask[:, -1] = mask[:, 0]
        for b in range(B):  # one mask value per (row, token)
            for j in range(tokens.shape[1]):
                mask[b, j] = mask[b, list(tokens[b]).index(tokens[b, j])]
    first = rng.integers(0, Vp, (B, 3)).astype(np.int32)
    jst = jax_sampling.note_tokens(jax_sampling.init_sampler_state(B, Vp), jnp.asarray(first))
    tst = sampling.note_tokens(sampling.init_sampler_state(B, Vp, "cpu"), torch.from_numpy(first))
    assert tst["presence"].dtype == torch.bool and np.array_equal(_presence(tst), _presence(jst))
    before = tst["presence"].clone()
    jst = jax_sampling.note_tokens(jst, jnp.asarray(tokens),
                                   None if mask is None else jnp.asarray(mask))
    tst2 = sampling.note_tokens(tst, torch.from_numpy(tokens),
                                None if mask is None else torch.from_numpy(mask))
    assert np.array_equal(_presence(tst2), _presence(jst))
    assert torch.equal(tst["presence"], before)  # functional: the input is not updated
    slots = np.asarray([True, False, True, False])
    jst = jax_sampling.reset_slots(jst, jnp.asarray(slots))
    tst3 = sampling.reset_slots(tst2, torch.from_numpy(slots))
    assert np.array_equal(_presence(tst3), _presence(jst)) and not _presence(tst3)[slots].any()
    assert _presence(tst2)[slots].any()  # functional: the input is not updated


def test_note_tokens_marks_any_masked_in_occurrence():
    """The port's rule where JAX leaves the result to its scatter's write
    order: a token held both masked in and masked out in a row is marked."""
    st = sampling.init_sampler_state(2, 8, "cpu")
    tokens = torch.tensor([[3, 3, 5], [4, 6, 4]])
    mask = torch.tensor([[True, False, False], [False, True, True]])
    got = sampling.note_tokens(st, tokens, mask)["presence"]
    want = torch.zeros(2, 8, dtype=torch.bool)
    want[0, 3] = want[1, 6] = want[1, 4] = True
    assert torch.equal(got, want)


# --------------------------------------------------------- int8 weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 40), (3, 48, 40)])
def test_dequantize_weight_matches_jax(shape, dtype):
    w = (np.random.default_rng(4).standard_normal(shape) * 0.1).astype(np.float32)
    jleaf = jax_quant.quantize_weight(jnp.asarray(w))
    leaf = {k: torch.from_numpy(np.array(v)) for k, v in jleaf.items()}
    want = np.asarray(jax_quant.dequantize_weight(jleaf, dtype=getattr(jnp, dtype)))
    got = quant.dequantize_weight(leaf, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    leaf["qt"] = leaf["q"].transpose(-1, -2).contiguous()  # a K-major copy is not read
    assert torch.equal(quant.dequantize_weight(leaf, dtype=getattr(torch, dtype)), got)
    mine = quant.quantize_weight(torch.from_numpy(w), axis=len(shape) - 2)
    assert all(np.array_equal(mine[k].numpy(), np.asarray(jleaf[k])) for k in ("q", "scale"))


def test_quantize_weight_takes_only_the_contraction_axis():
    w = torch.randn(8, 6)
    with pytest.raises(ValueError, match="axis"):
        quant.quantize_weight(w, axis=-1)
    with pytest.raises(AssertionError):
        jax_quant.quantize_weight(jnp.asarray(w.numpy()), axis=-1)


# ------------------------------------------------- dense decode oracle


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_reference_matches_jax(dtype):
    """GQA G = 3; slots of length 0 (the mean of V), 1, a 128-position
    tile edge, the full capacity, and one past it."""
    B, KV, G, S, HD = 5, 2, 3, 256, 64
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, KV * G, HD), (B, KV, S, HD), (B, KV, S, HD)))
    lens = np.asarray([0, 1, 128, S, S + 7], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_reference(*(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(lens))
    got = decode_attention_reference(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                                     torch.from_numpy(lens))
    assert got.dtype == td and tuple(got.shape) == (B, KV * G, HD)
    ref = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    else:
        assert np.all(np.abs(got.float().numpy() - ref) <= 1e-2 * np.abs(ref) + 2e-3)
    vmean = torch.from_numpy(v).to(td).float()[0].mean(dim=1)  # (KV, HD)
    np.testing.assert_allclose(got[0].float().reshape(KV, G, HD).numpy(),
                               np.repeat(vmean.numpy()[:, None], G, 1),
                               rtol=1e-2, atol=2e-3)


def test_importing_ops_loads_no_kernel():
    code = ("import project_morpheus_tpu_torch.ops as o\n"
            "from project_morpheus_tpu_torch.ops import build\n"
            "assert callable(o.decode_attention) and not build._libs, build._libs\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------- names


def _public_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _port_attr(ref: str):
    module, name = ref.split(":")
    mod = importlib.import_module("project_morpheus_tpu_torch." +
                                  module[:-3].replace("/", ".").removesuffix(".__init__"))
    return getattr(mod, name)


@pytest.mark.parametrize("sub", ["codec", "model", "ops"])
def test_jax_exports_import_from_the_port(sub):
    jax_all = _public_all(JAX_PKG / sub / "__init__.py")
    port = importlib.import_module(f"project_morpheus_tpu_torch.{sub}")
    assert not [n for n in jax_all if not hasattr(port, n)]
    assert set(jax_all) <= set(port.__all__)


def _public_all(path: pathlib.Path) -> list:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_every_jax_module_name_has_a_counterpart():
    missing, stale = [], []
    for jfile in sorted(JAX_PKG.rglob("*.py")):
        rel = jfile.relative_to(JAX_PKG).as_posix()
        target = name_map.MODULES.get(rel, rel)
        if target is None:
            continue
        pfile = PORT_PKG / target
        assert pfile.exists(), f"{rel}: no {target} in the port"
        have = _public_names(pfile)
        for name in sorted(_public_names(jfile)):
            key = f"{rel}:{name}"
            if key in name_map.NAMES:
                if name in have and target == rel:
                    stale.append(key)  # ported under its own name since
            elif name not in have:
                missing.append(key)
    assert not missing, missing
    assert not stale, stale


def test_name_map_entries_resolve():
    for key, ref in name_map.NAMES.items():
        rel, name = key.split(":")
        assert name in _public_names(JAX_PKG / rel), key
        assert _port_attr(ref) is not None, ref
    for rel, target in name_map.MODULES.items():
        assert (JAX_PKG / rel).exists() and (target is None or (PORT_PKG / target).exists())
    from project_morpheus_tpu_torch.codec import stream_decode
    from project_morpheus_tpu_torch.model import tokenizer
    assert stream_decode.snac_stream_step is stream_decode.snac_stream_body
    assert tokenizer.HFTokenizer is tokenizer.BPETokenizer
