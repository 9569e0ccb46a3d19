"""HF Llama checkpoint -> the port's parameter tree (port of
model/hf_weights.py).

Reads an HF release directory, as ``canopylabs/orpheus-3b-0.1-ft`` ships
it: ``config.json`` plus safetensors shards (one file, or several with
``model.safetensors.index.json``), or ``pytorch_model*.bin`` shards.
Safetensors files are read by this module's own reader (the 8-byte header
length, the JSON header, then ``torch.frombuffer`` over an ``mmap`` of the
file), so bf16 tensors go to the device as bf16, never through numpy or
fp32; ``.bin`` shards go through ``torch.load(weights_only=True,
mmap=True)``.

The tree is the layer-stacked layout of ``llama.init_llama_params``:
- HF Linear weights ``(out, in)`` are transposed to ``(in, out)``;
- q/k/v keep HF head order (rotate-half RoPE, GQA grouping as ``llama.py``);
- vocab rows are zero-padded up to ``cfg.padded_vocab``.

The load goes tensor by tensor, shard by shard: each tensor is copied
from the mapped file to the device and into a preallocated stacked
buffer, so the host holds at most the pages of one shard and the device
one tensor more than the result.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import mmap
import os
import re
import struct
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import torch

from .config import LlamaConfig

logger = logging.getLogger(__name__)

__all__ = ["load_hf_checkpoint", "hf_state_dict_to_params", "config_from_hf",
           "read_safetensors"]

Params = Dict[str, object]

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}


def config_from_hf(hf_config: Dict) -> LlamaConfig:
    """Build a LlamaConfig from an HF ``config.json`` dict.

    ``tie_word_embeddings`` defaults to False when absent, as in HF's
    ``LlamaConfig``; ``load_hf_checkpoint`` then infers the true value from
    the tensors the checkpoint holds."""
    rope = hf_config.get("rope_scaling") or {}
    if rope:
        rtype = rope.get("rope_type") or rope.get("type")
        if rtype != "llama3":
            raise ValueError(
                f"unsupported rope_scaling type {rtype!r}; only 'llama3' "
                "(low/high freq factor) scaling is implemented")
    head_dim = hf_config.get("head_dim") or (
        hf_config["hidden_size"] // hf_config["num_attention_heads"])
    return LlamaConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        intermediate_size=hf_config["intermediate_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        num_kv_heads=hf_config.get("num_key_value_heads", hf_config["num_attention_heads"]),
        head_dim=head_dim,
        max_seq_len=hf_config.get("max_position_embeddings", 8192),
        rope_theta=float(hf_config.get("rope_theta", 500_000.0)),
        rope_scaling_factor=float(rope.get("factor", 1.0)),
        rope_low_freq_factor=float(rope.get("low_freq_factor", 1.0)),
        rope_high_freq_factor=float(rope.get("high_freq_factor", 4.0)),
        rope_original_max_pos=int(rope.get("original_max_position_embeddings", 8192)),
        rms_eps=float(hf_config.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf_config.get("tie_word_embeddings", False)),
    )


# ----------------------------------------------------------- file readers


def _safetensors_header(path: Path) -> Dict[str, tuple]:
    """name -> (torch dtype or the file's dtype string, shape, first byte,
    end byte) with absolute file offsets."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    out = {}
    for name, e in header.items():
        lo, hi = e["data_offsets"]
        out[name] = (_ST_DTYPES.get(e["dtype"], e["dtype"]), tuple(e["shape"]),
                     8 + n + lo, 8 + n + hi)
    return out


def _iter_safetensors(path: Path, names: Optional[Iterable[str]] = None
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for each wanted tensor of one file, in file order.
    Each tensor is a view over a private mapping of the file; the mapping
    is released once the last view is gone."""
    entries = _safetensors_header(path)
    wanted = set(entries) if names is None else set(names) & set(entries)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, (dt, shape, lo, hi) in sorted(entries.items(), key=lambda kv: kv[1][2]):
        if name not in wanted:
            continue
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {dt}")
        n = (hi - lo) // dt.itemsize
        if n == 0:
            yield name, torch.empty(shape, dtype=dt)
            continue
        yield name, torch.frombuffer(mm, dtype=dt, count=n, offset=lo).view(shape)


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors in its dtypes
    (views over a mapping of the file)."""
    return dict(_iter_safetensors(Path(path)))


def _checkpoint_files(directory) -> Tuple[str, List[Path]]:
    """(``"safetensors"`` or ``"bin"``, shard paths) of an HF directory; an
    index file, where there is one, names the shards."""
    d = Path(os.path.expanduser(directory))
    for kind, index, pattern in (("safetensors", "model.safetensors.index.json", "*.safetensors"),
                                 ("bin", "pytorch_model.bin.index.json", "pytorch_model*.bin")):
        if (d / index).exists():
            weight_map = json.loads((d / index).read_text())["weight_map"]
            return kind, [d / f for f in sorted(set(weight_map.values()))]
        files = sorted(d.glob(pattern))
        if files:
            return kind, files
    raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin under {d}")


def _shard_names(kind: str, path: Path) -> List[str]:
    if kind == "safetensors":
        return list(_safetensors_header(path))
    return list(torch.load(str(path), map_location="cpu", weights_only=True, mmap=True))


def _iter_shard(kind: str, path: Path, names) -> Iterator[Tuple[str, torch.Tensor]]:
    if kind == "safetensors":
        yield from _iter_safetensors(path, names)
        return
    sd = torch.load(str(path), map_location="cpu", weights_only=True, mmap=True)
    for name in names:
        if name in sd:
            yield name, sd[name]


# ------------------------------------------------------------- conversion

_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(.+)")

_LAYER_KEY_MAP = {
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "wg",
    "mlp.up_proj.weight": "wu",
    "mlp.down_proj.weight": "wd",
    "input_layernorm.weight": "ln1",
    "post_attention_layernorm.weight": "ln2",
}
_EMBED_NAMES = ("model.embed_tokens.weight", "transformer.wte.weight")


def _wanted(name: str, tied: bool) -> bool:
    if name in _EMBED_NAMES or name == "model.norm.weight":
        return True
    if name == "lm_head.weight":
        return not tied
    m = _LAYER_RE.match(name)
    return bool(m) and m.group(2) in _LAYER_KEY_MAP


class _StackedParams:
    """Stacked parameter buffers on the device, filled one HF tensor at a
    time (layer weights transposed to ``(in, out)``, vocab rows padded)."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype, device) -> None:
        self.cfg, self.dtype, self.device = cfg, dtype, torch.device(device)
        L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
        Q, KVD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        self.shapes = {"wq": (D, Q), "wk": (D, KVD), "wv": (D, KVD), "wo": (Q, D),
                       "wg": (D, F_), "wu": (D, F_), "wd": (F_, D), "ln1": (D,), "ln2": (D,)}
        self.layers = {k: torch.empty((L,) + s, dtype=dtype, device=self.device)
                       for k, s in self.shapes.items()}
        self.filled = {k: [False] * L for k in self.shapes}
        self.embed = self.lm_head = self.ln_f = None

    def _padded(self, name: str, t: torch.Tensor, transpose: bool) -> torch.Tensor:
        V, D = t.shape
        Vp = self.cfg.padded_vocab
        if V > Vp:
            raise ValueError(f"checkpoint vocab {V} exceeds padded vocab {Vp}")
        if D != self.cfg.hidden_size:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, hidden size {self.cfg.hidden_size}")
        shape = (D, Vp) if transpose else (Vp, D)
        out = torch.zeros(shape, dtype=self.dtype, device=self.device)
        src = t.to(self.device)
        if transpose:
            out[:, :V].copy_(src.T)
        else:
            out[:V].copy_(src)
        return out

    def add(self, name: str, t: torch.Tensor) -> None:
        if name in _EMBED_NAMES:
            self.embed = self._padded(name, t, False)
            return
        if name == "lm_head.weight":
            self.lm_head = self._padded(name, t, True)
            return
        if name == "model.norm.weight":
            self.ln_f = t.to(self.device, self.dtype).clone()
            return
        m = _LAYER_RE.match(name)
        key = _LAYER_KEY_MAP.get(m.group(2)) if m else None
        if key is None:
            return  # rotary inv_freq buffers etc.
        idx, shape = int(m.group(1)), self.shapes[key]
        if idx >= self.cfg.num_layers:
            raise ValueError(f"{name}: layer {idx}, but the config has "
                             f"{self.cfg.num_layers} layers")
        want = shape[::-1] if len(shape) == 2 else shape  # HF stores (out, in)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        src = t.to(self.device)
        self.layers[key][idx].copy_(src.T if len(shape) == 2 else src)
        self.filled[key][idx] = True

    def finish(self) -> Params:
        if self.embed is None or self.ln_f is None:
            raise ValueError("state dict missing embed_tokens / model.norm")
        if not self.cfg.tie_embeddings and self.lm_head is None:
            raise ValueError(
                "config says untied embeddings (tie_word_embeddings=False) but "
                "the checkpoint has no lm_head.weight; pass a cfg with "
                "tie_embeddings=True or use load_hf_checkpoint (which infers)")
        for key, rows in self.filled.items():
            missing = [i for i, ok in enumerate(rows) if not ok]
            if missing:
                raise ValueError(f"layers missing for {key}: {missing[:4]}...")
        params: Params = {"embed": self.embed, "layers": self.layers, "ln_f": self.ln_f}
        if self.lm_head is not None and not self.cfg.tie_embeddings:
            params["lm_head"] = self.lm_head
        return params


def hf_state_dict_to_params(state: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                            dtype: torch.dtype = torch.bfloat16, device="cuda") -> Params:
    """Convert a flat HF Llama state dict (torch tensors) to the port's tree."""
    stack = _StackedParams(cfg, dtype, device)
    for name, t in state.items():
        if _wanted(name, cfg.tie_embeddings):
            stack.add(name, torch.as_tensor(t))
    return stack.finish()


def load_hf_checkpoint(directory, cfg: Optional[LlamaConfig] = None,
                       dtype: torch.dtype = torch.bfloat16, device="cuda"
                       ) -> Tuple[Params, LlamaConfig]:
    """Load an HF Llama/Orpheus checkpoint directory into (params, cfg) on
    ``device``; the config comes from ``config.json`` unless ``cfg`` is given."""
    d = Path(os.path.expanduser(directory))
    hf_cfg: Optional[Dict] = None
    if cfg is None:
        cfg_path = d / "config.json"
        if not cfg_path.exists():
            raise FileNotFoundError(f"{cfg_path} not found; pass cfg explicitly")
        hf_cfg = json.loads(cfg_path.read_text())
        cfg = config_from_hf(hf_cfg)
    kind, files = _checkpoint_files(d)
    shard_names = {f: _shard_names(kind, f) for f in files}
    if hf_cfg is not None:
        # config.json without tie_word_embeddings: trust the tensors (an
        # untied checkpoint ships lm_head.weight, a tied one does not)
        tied_in_state = not any("lm_head.weight" in ns for ns in shard_names.values())
        if "tie_word_embeddings" not in hf_cfg:
            cfg = dataclasses.replace(cfg, tie_embeddings=tied_in_state)
        elif tied_in_state and not cfg.tie_embeddings:
            logger.warning("config.json declares untied embeddings but the checkpoint "
                           "has no lm_head.weight; falling back to tied")
            cfg = dataclasses.replace(cfg, tie_embeddings=True)
    stack = _StackedParams(cfg, dtype, device)
    for f, names in shard_names.items():
        for name, t in _iter_shard(kind, f, [n for n in names if _wanted(n, cfg.tie_embeddings)]):
            stack.add(name, t)
            del t
    return stack.finish(), cfg
