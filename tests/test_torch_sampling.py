"""The port's sampler against the JAX package's: greedy choices and the
top-p nucleus (both found by the same 24-step bisection) must be equal,
not merely close.  The random draws differ by design (a counter-based
generator in the port, ``jax.random`` keys in JAX); their properties are
checked on their own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from project_morpheus_tpu.model import sampling as js
from project_morpheus_tpu_torch.model import sampling as ts


def _inputs(seed, B=4, Vp=1024, V=1000):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, Vp)) * 3).astype(np.float32)
    presence = rng.random((B, Vp)) < 0.05
    temp = np.asarray([0.0, 0.6, 1.0, 1.4], np.float32)[:B]
    top_p = np.asarray([0.9, 0.5, 0.95, 0.2], np.float32)[:B]
    pen = np.asarray([1.1, 1.3, 1.0, 1.2], np.float32)[:B]
    return logits, presence, temp, top_p, pen, V


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_matches_jax(seed):
    logits, presence, _, top_p, pen, V = _inputs(seed)
    zero = np.zeros(len(logits), np.float32)
    want = js.sample_logits(jnp.asarray(logits), jax.random.key(0), temperature=jnp.asarray(zero),
                            top_p=jnp.asarray(top_p), repetition_penalty=jnp.asarray(pen),
                            presence=jnp.asarray(presence), vocab_size=V)
    none = torch.zeros(len(logits), dtype=torch.int64)
    got = ts.sample_logits(torch.tensor(logits), none, none,
                           temperature=torch.tensor(zero), top_p=torch.tensor(top_p),
                           repetition_penalty=torch.tensor(pen),
                           presence=torch.tensor(presence), vocab_size=V)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nucleus_sets_match_jax(seed, monkeypatch):
    """The JAX sampler's nucleus logits are caught at its categorical draw
    and compared, id by id, with the port's nucleus."""
    logits, presence, temp, top_p, pen, V = _inputs(seed)
    seen = {}

    def catch(key, nucleus, axis=-1):
        seen["nucleus"] = np.asarray(nucleus)
        return jnp.argmax(nucleus, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", catch)
    js.sample_logits(jnp.asarray(logits), jax.random.key(0), temperature=jnp.asarray(temp),
                     top_p=jnp.asarray(top_p), repetition_penalty=jnp.asarray(pen),
                     presence=jnp.asarray(presence), vocab_size=V)
    pl = ts.penalized_logits(torch.tensor(logits), repetition_penalty=torch.tensor(pen),
                             presence=torch.tensor(presence), vocab_size=V)
    scaled = pl / torch.clamp(torch.tensor(temp), min=1e-4)[:, None]
    got = ts.nucleus_logits(scaled, torch.tensor(top_p))
    want_set = np.isfinite(seen["nucleus"])
    np.testing.assert_array_equal(torch.isfinite(got).numpy(), want_set)
    assert want_set.sum(axis=1).min() >= 1


def test_draws_follow_each_slots_generator():
    """A lane's draw depends only on its own (seed, draw counter): the same
    pair gives the same token whatever the other lanes hold, another
    counter gives other noise, and draws stay in the nucleus."""
    logits, presence, _, top_p, pen, V = _inputs(4)
    temp = torch.full((4,), 1.0)

    def draw(seeds, draws):
        return ts.sample_logits(torch.tensor(logits), torch.tensor(seeds), torch.tensor(draws),
                                temperature=temp, top_p=torch.tensor(top_p),
                                repetition_penalty=torch.tensor(pen),
                                presence=torch.tensor(presence), vocab_size=V)

    a, b = draw([1, 2, 3, 2**40 + 4], [0, 0, 5, 7]), draw([1, 9, 0, 2**40 + 4], [0, 3, 0, 7])
    assert a[0] == b[0] and a[3] == b[3]
    bits = ts.uniform_bits(torch.tensor([1, 1, 2]), torch.tensor([0, 1, 0]), 4096)
    assert not torch.equal(bits[0], bits[1]) and not torch.equal(bits[0], bits[2])
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
    # 24-bit uniforms: mean 1/2, and no two lanes of a draw coincide much
    u = (bits >> 8).double() / 2**24
    assert abs(float(u.mean()) - 0.5) < 0.01
    pl = ts.penalized_logits(torch.tensor(logits), repetition_penalty=torch.tensor(pen),
                             presence=torch.tensor(presence), vocab_size=V)
    nuc = ts.nucleus_logits(pl / temp[:, None], torch.tensor(top_p))
    assert all(torch.isfinite(nuc[i, a[i]]) for i in range(4))


@pytest.mark.parametrize("streams", ["one_seed_draws_0_to_n", "n_seeds_at_draw_0"])
def test_draw_frequencies_follow_nucleus_softmax(streams):
    """200,000 draws over 64 ids at top_p 0.9 and temperature 0.8, from
    one seed at draws 0..N-1 or from N seeds at draw 0: the kept ids
    (equal to a float64 numpy nucleus) hold every draw, and their counts
    pass a chi-square test against the renormalised nucleus softmax at
    p > 1e-3."""
    from scipy.stats import chisquare

    V, N, temp, top_p = 64, 200_000, 0.8, 0.9
    row = (np.random.default_rng(21).standard_normal(V) * 1.5).astype(np.float32)
    scaled = row.astype(np.float64) / temp
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    order = np.argsort(-p)
    nucleus = np.zeros(V, bool)
    nucleus[order[:np.searchsorted(np.cumsum(p[order]), top_p) + 1]] = True
    expected = np.where(nucleus, p, 0.0) / p[nucleus].sum()
    got_set = ts.nucleus_logits(torch.tensor(row)[None] / temp, torch.tensor([top_p]))
    np.testing.assert_array_equal(torch.isfinite(got_set[0]).numpy(), nucleus)

    counts = np.zeros(V, np.int64)
    for lo in range(0, N, 50_000):
        n = min(50_000, N - lo)
        span = torch.arange(lo, lo + n, dtype=torch.int64)
        if streams == "one_seed_draws_0_to_n":
            seeds, draws = torch.full((n,), 12345, dtype=torch.int64), span
        else:
            seeds, draws = span, torch.zeros(n, dtype=torch.int64)
        tok = ts.sample_logits(torch.tensor(row).expand(n, V), seeds, draws,
                               temperature=torch.full((n,), temp), top_p=torch.full((n,), top_p),
                               repetition_penalty=torch.ones(n),
                               presence=torch.zeros((n, V), dtype=torch.bool), vocab_size=V)
        counts += np.bincount(tok.numpy(), minlength=V)
    assert counts[~nucleus].sum() == 0 and counts.sum() == N
    assert chisquare(counts[nucleus], N * expected[nucleus]).pvalue > 1e-3
