"""The port's SNAC checkpoint converter (project_morpheus_tpu_torch.tools.
convert_snac) against the JAX package's ``scripts/convert_snac.py``: the
same rename map, the same converted arrays (exact), from snac-package key
names reconstructed by inverting the map, from a weight-norm checkpoint,
and read back from safetensors (fp32 and bf16) and ``.pt`` files."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from project_morpheus_tpu_torch.codec import SNACConfig
from project_morpheus_tpu_torch.codec.weights import random_torch_state
from project_morpheus_tpu_torch.tools import convert_snac as port

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import convert_snac as ref  # noqa: E402

safetensors_torch = pytest.importorskip("safetensors.torch")


@pytest.fixture(scope="module")
def cfg():
    return SNACConfig.tiny()


def _snac_named(cfg, seed):
    inv = {dst: src for src, dst in port.snac_rename_map(cfg, True).items()}
    return {inv[k]: v for k, v in random_torch_state(cfg, seed).items()}


@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("size", ["tiny", "snac_24khz"])
def test_rename_map_matches_jax(size, noise):
    c = getattr(SNACConfig, size)()
    assert port.snac_rename_map(c, noise) == ref.snac_rename_map(c, noise)


def test_convert_matches_jax(cfg):
    named = _snac_named(cfg, 5)
    w = named.pop("decoder.model.1.weight")  # one conv as a weight-norm pair
    named["decoder.model.1.weight_v"] = w
    named["decoder.model.1.weight_g"] = np.sqrt(np.sum(w**2, axis=(1, 2), keepdims=True))
    got, want = port.convert(dict(named), cfg), ref.convert(dict(named), cfg)
    assert set(got) == set(want) == set(random_torch_state(cfg, 5))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    named["decoder.model.999.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        port.convert(named, cfg)
    assert "decoder.model.999.weight" not in port.convert(named, cfg, strict=False)


def test_load_torch_state_files_and_main(cfg, tmp_path):
    named = _snac_named(cfg, 6)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in named.items()}
    safetensors_torch.save_file(tensors, tmp_path / "model.safetensors")
    torch.save(tensors, tmp_path / "snac.pt")
    bf16 = {k: v.to(torch.bfloat16) for k, v in tensors.items()}
    safetensors_torch.save_file(bf16, tmp_path / "bf16.safetensors")
    for path, want in ((tmp_path, tensors), (tmp_path / "snac.pt", tensors),
                       (tmp_path / "bf16.safetensors", bf16)):
        got = port.load_torch_state(str(path))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.float().numpy(), err_msg=k)
    out = tmp_path / "snac.npz"
    assert port.main([str(tmp_path / "snac.pt"), "-o", str(out)]) == 0
    with np.load(out) as npz:
        canonical = random_torch_state(cfg, 6)
        assert set(npz.files) == set(canonical)
        for k, v in canonical.items():
            np.testing.assert_array_equal(npz[k], v)
