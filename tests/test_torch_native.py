"""The port's native C++ PCM library against the Python twins (the port's
and the JAX package's), and the ``ORPHEUS_NATIVE_PCM=1`` hooks of the
port's ring buffer and stitcher."""
import numpy as np
import pytest
import torch

from project_morpheus_tpu.orchestrator.ring_buffer import RingBuffer as JaxRing
from project_morpheus_tpu.orchestrator.stitcher import crossfade as jax_crossfade
from project_morpheus_tpu_torch import native
from project_morpheus_tpu_torch.orchestrator.ring_buffer import RingBuffer
from project_morpheus_tpu_torch.orchestrator.stitcher import crossfade


def _python_path(monkeypatch):
    monkeypatch.delenv(native.FLAG, raising=False)


@pytest.fixture
def flag_on(monkeypatch):
    monkeypatch.setenv(native.FLAG, "1")


def test_library_builds_into_the_ports_own_directory():
    lib = native.load()
    assert lib is native.load()
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "project_morpheus_tpu_torch" in path.parts


@pytest.mark.parametrize("cap,ops", [
    (16, [(b"abcdefgh", 3), (b"ijklmnop", 10), (b"qrstuv", 4)]),
    # wraparound on both the write and the read side, then overflow
    (8, [(b"abcdef", 4), (b"ghijkl", 8), (b"0123456789", 3), (b"", 9)]),
    (5, [(b"ab", 0), (b"cdefg", 5), (b"hijklmnop", 2), (b"qr", 6)]),
])
def test_ring_matches_python_twins(monkeypatch, cap, ops):
    _python_path(monkeypatch)
    nat = native.NativeRing(cap)
    ref, jref = RingBuffer(cap, 24_000), JaxRing(cap, 24_000)
    for data, rd in ops:
        n = nat.write(data)
        assert n == ref.write(data) == jref.write(data)
        assert nat.free == ref.free == jref.free
        got = nat.read(rd)
        assert got == ref.read(rd) == jref.read(rd)
        assert len(nat) == len(ref) == len(jref)
    nat.reset()
    ref.reset()
    assert len(nat) == len(ref) == 0 and nat.free == cap


@pytest.mark.parametrize("ov", [-3, 0, 1, 2, 99, 100, 101, 149, 150, 151, 400])
def test_crossfade_equals_python_twins_at_every_overlap_edge(monkeypatch, ov):
    """Overlaps below zero, at 0 and 1, at one side's size and either side
    of it, and past both: bit-equal to the port's and JAX's Python joins."""
    _python_path(monkeypatch)
    rng = np.random.default_rng(ov + 10)
    tail = rng.integers(-32768, 32768, 100).astype(np.int16)
    head = rng.integers(-32768, 32768, 150).astype(np.int16)
    tail[-5:] = 32767  # mixes near full scale on both sides
    head[:5] = -32768
    got = native.crossfade_join(tail, head, ov)
    np.testing.assert_array_equal(got, crossfade(tail, head, ov))
    np.testing.assert_array_equal(got, jax_crossfade(tail, head, ov))


def test_f32_to_i16_clips_and_truncates():
    import jax.numpy as jnp

    from project_morpheus_tpu.codec.streaming import _to_int16

    rng = np.random.default_rng(0)
    inside = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
    inside[:4] = [0.0, 0.5, -0.5, 1.0]
    got = native.f32_to_i16(inside)
    np.testing.assert_array_equal(got, np.asarray(_to_int16(jnp.asarray(inside))))
    np.testing.assert_array_equal(got, (torch.from_numpy(inside) * 32767.0).to(torch.int16).numpy())
    outside = np.asarray([1.0001, 1.5, -1.5, -1.00005, 40.0, -40.0], np.float32)
    want = np.clip(outside * np.float32(32767.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(native.f32_to_i16(outside), want)
    assert native.f32_to_i16(outside).tolist() == [32767, 32767, -32768, -32768, 32767, -32768]


def test_meter_matches_numpy():
    rng = np.random.default_rng(1)
    pcm = rng.integers(-32768, 32768, 10_000).astype(np.int16)
    rms, peak = native.meter(pcm)
    v = np.abs(pcm.astype(np.float64)) / 32768.0
    assert rms == pytest.approx(float(np.sqrt(np.mean(v * v))), rel=1e-12)
    assert peak == pytest.approx(float(v.max()), rel=1e-15)
    assert native.meter(np.zeros(0, np.int16)) == (0.0, 0.0)


def test_flag_puts_ring_on_the_library(monkeypatch):
    monkeypatch.delenv(native.FLAG, raising=False)
    ref = RingBuffer(64, 24_000)  # the Python twin
    monkeypatch.setenv(native.FLAG, "1")
    assert native.enabled()
    ring = RingBuffer(64, 24_000)
    assert ref._native is None and isinstance(ring._native, native.NativeRing)
    rng = np.random.default_rng(2)
    for _ in range(40):
        data = rng.integers(0, 256, int(rng.integers(0, 50))).astype(np.uint8).tobytes()
        assert ring.write(data) == ref.write(data)
        k = int(rng.integers(0, 70))
        assert ring.read(k) == ref.read(k)
        assert len(ring) == len(ref) and ring.free == ref.free


def test_flag_puts_crossfade_on_the_library(flag_on, monkeypatch):
    calls = []
    real = native.crossfade_join

    def spy(tail, head, overlap):
        calls.append(overlap)
        return real(tail, head, overlap)

    monkeypatch.setattr(native, "crossfade_join", spy)
    rng = np.random.default_rng(3)
    tail = rng.integers(-30000, 30000, 480).astype(np.int16)
    head = rng.integers(-30000, 30000, 960).astype(np.int16)
    got = crossfade(tail, head, 240)
    assert calls == [240]
    np.testing.assert_array_equal(got, jax_crossfade(tail, head, 240))


def test_stitched_stream_equal_with_and_without_the_flag(monkeypatch):
    import asyncio

    from project_morpheus_tpu_torch.orchestrator.adapter import AudioChunk
    from project_morpheus_tpu_torch.orchestrator.stitcher import stitch_chunks

    rng = np.random.default_rng(4)
    pcms = [rng.integers(-20000, 20000, n).astype(np.int16).tobytes() for n in (700, 90, 1200)]

    async def run():
        async def chunks():
            for i, p in enumerate(pcms):
                yield AudioChunk(pcm=p, duration_ms=0.0, eos=i == len(pcms) - 1)
        return b"".join([c.pcm async for c in stitch_chunks(
            chunks(), sample_rate=24_000, overlap_ms=5.0)])

    monkeypatch.delenv(native.FLAG, raising=False)
    plain = asyncio.run(run())
    monkeypatch.setenv(native.FLAG, "1")
    assert asyncio.run(run()) == plain


def test_flag_unset_builds_nothing(monkeypatch):
    monkeypatch.delenv(native.FLAG, raising=False)

    def refuse(*_):
        raise AssertionError("built with the flag unset")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", refuse)
    assert native.enabled() is False
    assert RingBuffer(8, 24_000)._native is None


def test_flag_set_and_build_failure_raises(monkeypatch, tmp_path):
    """Divergence from the JAX package, whose ``enabled()`` returns False
    when the library cannot be built."""
    monkeypatch.setenv(native.FLAG, "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.enabled()
    with pytest.raises(RuntimeError):
        RingBuffer(8, 24_000)
    assert native.available() is False
