"""The port's SNAC encoder (``codec/snac.py:snac_encode``) against the JAX
package's on the same random weights (``codec/weights.py``'s numpy
draws, carried across with ``model/bridge.py``), fp32 on the CPU: the
codes of every level must be equal.

The audio is a whole number of 4-frame groups (the coarse level's stride
times the 512-sample hop), as SNAC pads its input; ``SNACConfig.tiny()``
declares a 16-wide latent its 64-channel encoder does not produce, so
both packages refuse to encode with it, and the tiny case runs with the
latent its encoder gives."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.codec import snac_jax as js
from project_morpheus_tpu.codec.snac_config import SNACConfig as JaxSNACConfig
from project_morpheus_tpu.codec.weights import init_snac_params as jax_init
from project_morpheus_tpu_torch.codec import snac as ts
from project_morpheus_tpu_torch.codec.snac_config import SNACConfig
from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy


def _setup(name, samples, seed):
    jcfg = dataclasses.replace(getattr(JaxSNACConfig, name)(), latent_dim=None)
    cfg = dataclasses.replace(getattr(SNACConfig, name)(), latent_dim=None)
    jp = jax_init(jcfg, seed=seed)
    audio = (np.random.default_rng(seed).standard_normal((1, samples)) * 0.1).astype(np.float32)
    return jcfg, cfg, jp, params_from_jax_numpy(jax.tree.map(np.asarray, jp)), audio


@pytest.mark.parametrize("name,samples", [("tiny", 2 * 2048), ("snac_24khz", 12 * 2048)])
def test_snac_encode_matches_jax(name, samples):
    """``snac_24khz`` at 24,576 samples (1.024 s at 24 kHz)."""
    jcfg, cfg, jp, tp, audio = _setup(name, samples, seed=1)
    want = jax.jit(js.snac_encode, static_argnums=2)(jp, jnp.asarray(audio), jcfg)
    got = ts.snac_encode(tp, torch.tensor(audio), cfg)
    assert len(got) == len(want) == 3
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"level {level}")
    _, margins = ts.rvq_encode(tp, torch.zeros(1, 8, cfg.latent), cfg)
    assert all(bool((m >= 0).all()) for m in margins)


def test_tiny_latent_mismatch_refused_by_both():
    jcfg, cfg = JaxSNACConfig.tiny(), SNACConfig.tiny()
    jp = jax_init(jcfg, seed=0)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    audio = np.zeros((1, 4096), np.float32)
    with pytest.raises(TypeError):
        jax.jit(js.snac_encode, static_argnums=2)(jp, jnp.asarray(audio), jcfg)
    with pytest.raises(RuntimeError):
        ts.snac_encode(tp, torch.tensor(audio), cfg)
