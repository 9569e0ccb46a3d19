"""The port stands alone: importing every module of
project_morpheus_tpu_torch loads neither JAX nor the JAX package, and the
modules it copies from the JAX package (configs, token ids, prompt
format, frame math) still equal their originals."""
import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from project_morpheus_tpu.codec import SNACConfig as JaxSNACConfig
from project_morpheus_tpu.codec.frames import tokens_to_codes as jax_tokens_to_codes
from project_morpheus_tpu.model import ORPHEUS_SPECIAL_TOKENS as JAX_TOKENS
from project_morpheus_tpu.model import LlamaConfig as JaxLlamaConfig
from project_morpheus_tpu.model.tokenizer import format_prompt_ids as jax_format
from project_morpheus_tpu_torch.codec import SNACConfig, tokens_to_codes
from project_morpheus_tpu_torch.model import ORPHEUS_SPECIAL_TOKENS, LlamaConfig
from project_morpheus_tpu_torch.model.tokenizer import ByteTokenizer, format_prompt_ids

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import project_morpheus_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "project_morpheus_tpu"
             or m.startswith("project_morpheus_tpu."))
print(len(names), bad)
assert len(names) > 20 and not bad, bad
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax|.*project_morpheus_tpu\.|"
                     r"from project_morpheus_tpu |import project_morpheus_tpu\b)", re.M)
    files = list((ROOT / "project_morpheus_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_copied_configs_equal_jax():
    for name in ("orpheus_3b", "orpheus_1b", "tiny", "tiny_vocab"):
        assert dataclasses.asdict(getattr(LlamaConfig, name)()) == \
            dataclasses.asdict(getattr(JaxLlamaConfig, name)())
        assert getattr(LlamaConfig, name)().padded_vocab == getattr(JaxLlamaConfig, name)().padded_vocab
    for name in ("snac_24khz", "tiny"):
        a, b = getattr(SNACConfig, name)(), getattr(JaxSNACConfig, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.latent, a.hop_length, a.frame_samples) == (b.latent, b.hop_length, b.frame_samples)
    assert ORPHEUS_SPECIAL_TOKENS == JAX_TOKENS


def test_copied_prompt_and_frame_math_equal_jax():
    for voice in ("tara", None):
        assert format_prompt_ids("Hello <laugh> there", voice, ByteTokenizer()) == \
            jax_format("Hello <laugh> there", voice)
    toks = np.random.default_rng(0).integers(0, 4096, (2, 35)).astype(np.int32)
    for a, b in zip(tokens_to_codes(torch.tensor(toks)), jax_tokens_to_codes(toks)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
