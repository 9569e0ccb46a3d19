"""The port's SNAC decoder and exact stream decoder against the JAX
package's, on identical weights (both built from the same seeded numpy
state), plus the stream decoder's own gold property: each emitted frame
equals a decode of the prefix it has seen.

fp32 on both sides: waveforms agree to 1e-4; int16 PCM may differ by the
truncation of a last-bit difference (<= 2 LSB)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.codec import SNACConfig as JaxSNACConfig
from project_morpheus_tpu.codec import init_snac_params as jax_snac_init
from project_morpheus_tpu.codec.frames import tokens_to_codes as jax_tokens_to_codes
from project_morpheus_tpu.codec.snac_jax import snac_decode as jax_snac_decode
from project_morpheus_tpu.codec.stream_decode import init_stream_state as jax_init_state
from project_morpheus_tpu.codec.stream_decode import snac_stream_step as jax_stream_step
from project_morpheus_tpu_torch.codec import SNACConfig, tokens_to_codes
from project_morpheus_tpu_torch.codec import stream_decode as sd
from project_morpheus_tpu_torch.codec.snac import snac_decode
from project_morpheus_tpu_torch.codec.weights import init_snac_params
from project_morpheus_tpu_torch.model.bridge import params_from_jax_numpy


@pytest.fixture(scope="module")
def setup():
    cfg = SNACConfig.tiny()
    return cfg, jax_snac_init(JaxSNACConfig.tiny(), seed=3), init_snac_params(cfg, 3, "cpu")


def _lsb(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max()


def test_random_weights_identical_to_jax(setup):
    _, jparams, tparams = setup
    carried = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    flat_t = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tparams))
    flat_c = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), carried))
    assert len(flat_t) == len(flat_c) > 0
    for a, b in zip(flat_t, flat_c):
        np.testing.assert_array_equal(a, b)


def test_snac_decode_matches_jax(setup):
    cfg, jparams, tparams = setup
    toks = np.random.default_rng(0).integers(0, 4096, (2, 6 * 7)).astype(np.int32)
    want = jax.jit(jax_snac_decode, static_argnums=2)(
        jparams, jax_tokens_to_codes(jnp.asarray(toks)), cfg)
    got = snac_decode(tparams, tokens_to_codes(torch.tensor(toks)), cfg)
    assert got.shape == (2, 6 * cfg.frame_samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_stream_body_matches_jax_with_commit_masks(setup):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(1)
    js = jax_init_state(cfg, 2)
    ts = sd.init_stream_state(cfg, 2, "cpu")
    for hop in range(4):
        win = rng.integers(0, 4096, (2, sd.WINDOW_FRAMES * 7)).astype(np.int32)
        commit = np.asarray([True, hop % 2 == 0])
        jpcm, js = jax_stream_step(jparams, jnp.asarray(win), js, jnp.asarray(commit), cfg=cfg)
        tpcm, ts = sd.snac_stream_body(tparams, torch.tensor(win), ts, torch.tensor(commit),
                                       cfg=cfg)
        assert _lsb(tpcm.numpy(), jpcm) <= 2
    for name in js:
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]), rtol=1e-4, atol=1e-4)


def test_stream_decode_equals_prefix_decode(setup):
    """ExactStreamDecoder fed codes one by one: each steady frame equals
    the same frame of a decode of the prefix seen so far, and the flushed
    tail the same frames of a decode of the whole stream."""
    cfg, _, tparams = setup
    rng = np.random.default_rng(2)
    N = 7
    codes = rng.integers(0, 4096, N * 7).astype(np.int32)
    dec = sd.ExactStreamDecoder(tparams, cfg)
    out = dec.push_tokens(codes.tolist()) + dec.flush()
    assert len(out) == N
    fs = cfg.frame_samples

    def frame_of(prefix_frames, e):
        audio = snac_decode(tparams, tokens_to_codes(torch.tensor(codes[None, : prefix_frames * 7])),
                            cfg)
        return (audio[0, e * fs:(e + 1) * fs] * 32767.0).to(torch.int16).numpy()

    for t in range(3, N):  # steady hop at frame t emits frame t-2
        assert _lsb(out[t - 2], frame_of(t + 1, t - 2)) <= 2
    for e in (N - 2, N - 1):  # flush tail: decoded against the full stream
        assert _lsb(out[e], frame_of(N, e)) <= 2
