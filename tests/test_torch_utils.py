"""The port's host utilities against the JAX package's: the performance
monitor under an injected clock, timeline replay to WAV, the watermark and
the optional local playback."""
import base64
import json
import types

import numpy as np
import pytest

from project_morpheus_tpu.utils import perf as jperf
from project_morpheus_tpu.utils import playback as jplay
from project_morpheus_tpu.utils import replay as jreplay
from project_morpheus_tpu.utils import watermark as jwm
from project_morpheus_tpu_torch.utils import perf, playback, replay, watermark


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def test_perf_monitor_matches_jax_under_an_injected_clock(monkeypatch):
    clock = _Clock()
    for mod in (perf, jperf):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    got, want = [], []
    ours = perf.PerformanceMonitor(report_interval_s=1.5, emit=got.append)
    theirs = jperf.PerformanceMonitor(report_interval_s=1.5, emit=want.append)
    for step in range(30):
        clock.t += 0.25
        for m in (ours, theirs):
            m.add_tokens(7)
            if step % 3 == 0:
                m.add_chunks()
        assert ours.stats() == theirs.stats()
    assert got == want and len(got) >= 4
    assert perf.SECONDS_PER_CHUNK == jperf.SECONDS_PER_CHUNK


def _timeline(rng, n):
    return [{"stage": "adapter_pull", "chunk_id": i,
             "pcm": base64.b64encode(rng.integers(-30000, 30000, int(rng.integers(0, 900)))
                                     .astype("<i2").tobytes()).decode()}
            for i in range(n)] + [{"stage": "eos"}]


@pytest.mark.parametrize("form", ["jsonl", "array", "envelope", "empty"])
def test_replay_wav_equals_jax_byte_for_byte(tmp_path, form):
    events = _timeline(np.random.default_rng(7), 0 if form == "empty" else 9)
    log = tmp_path / "t.log"
    if form == "jsonl":
        log.write_text("\n".join(json.dumps(e) for e in events))
    elif form == "array":
        log.write_text(json.dumps(events))
    elif form == "envelope":
        log.write_text(json.dumps({"events": events, "metrics": {}}))
    else:
        log.write_text("")
    assert replay.load_events(log) == jreplay.load_events(log)
    n = replay.replay_to_wav(log, tmp_path / "ours.wav", 24_000)
    assert n == jreplay.replay_to_wav(log, tmp_path / "theirs.wav", 24_000)
    assert (tmp_path / "ours.wav").read_bytes() == (tmp_path / "theirs.wav").read_bytes()


def test_replay_cli(tmp_path, capsys):
    log = tmp_path / "t.jsonl"
    log.write_text("\n".join(json.dumps(e) for e in _timeline(np.random.default_rng(8), 3)))
    replay.main([str(log), "-o", str(tmp_path / "a.wav"), "-r", "22050"])
    jreplay.main([str(log), "-o", str(tmp_path / "b.wav"), "-r", "22050"])
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    assert "PCM bytes" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_watermark_equals_jax(kind):
    rng = np.random.default_rng(11)
    t = np.arange(24_000 * 2) / 24_000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    if kind == "int16":
        audio = (audio * 32767).astype(np.int16)
    key = (3, 1, 4, 1, 5)
    ours, theirs = watermark.embed(audio, key), jwm.embed(audio, key)
    assert ours.dtype == theirs.dtype == audio.dtype
    np.testing.assert_array_equal(ours, theirs)
    assert watermark.detect(ours, key) == jwm.detect(theirs, key)
    assert watermark.verify(ours, key) and not watermark.verify(audio, key)
    assert not watermark.verify(ours, watermark.DEFAULT_KEY)
    up = watermark.resample(ours, 24_000, 44_100)
    np.testing.assert_array_equal(up, jwm.resample(theirs, 24_000, 44_100))
    back = watermark.resample(up, 44_100, 24_000)
    np.testing.assert_array_equal(back, jwm.resample(up, 44_100, 24_000))
    assert watermark.verify(back, key)


def test_playback_headless_counts_bytes_as_jax(monkeypatch):
    monkeypatch.setattr(playback, "_sd", None)
    monkeypatch.setattr(jplay, "_sd", None)
    assert playback.playback_available() is jplay.playback_available() is False
    assert playback.stream_audio(b"\x01\x00" * 10) is jplay.stream_audio(b"\x01\x00" * 10) is False
    assert playback.stream_audio(b"") is False
    ours, theirs = playback.LocalPlayback(), jplay.LocalPlayback()
    for hop in (b"\x00\x01" * 2048, b"", None, b"\x02\x00" * 7):
        ours.play(hop)
        theirs.play(hop)
    assert ours.bytes_played == theirs.bytes_played == 2 * 2048 + 14
    assert ours.available is theirs.available is False
    ours.close()


def test_playback_plays_through_sounddevice_when_present(monkeypatch):
    played = []

    class Stream:
        def __init__(self, **kw):
            played.append(("open", kw))

        def start(self):
            pass

        def write(self, a):
            played.append(("write", a.copy()))

        def stop(self):
            played.append(("stop",))

        def close(self):
            pass

    fake = types.SimpleNamespace(
        OutputStream=Stream, play=lambda a, sr: played.append(("play", a.copy(), sr)),
        wait=lambda: None)
    monkeypatch.setattr(playback, "_sd", fake)
    assert playback.playback_available()
    assert playback.stream_audio(np.asarray([16383, -16384], np.int16).tobytes())
    np.testing.assert_allclose(played[-1][1], np.asarray([16383, -16384]) / 32767.0)
    player = playback.LocalPlayback(sample_rate=24_000)
    assert player.available
    player.play(np.asarray([1, 2, 3], np.int16).tobytes())
    player.close()
    assert played[1] == ("open", {"samplerate": 24_000, "channels": 1, "dtype": "int16"})
    assert played[2][0] == "write" and played[2][1].tolist() == [1, 2, 3]
    assert played[-1] == ("stop",) and player.bytes_played == 6


@pytest.mark.parametrize("mod", [
    "native", "parallel", "parallel.mesh", "parallel.sharding", "server", "server.client",
    "utils.perf", "utils.playback", "utils.replay", "utils.watermark"])
def test_public_names_cover_jax(mod):
    """Every public function, class and constant the JAX module defines has
    a counterpart of the same name in the port's (imported names aside)."""
    import importlib

    jm = importlib.import_module(f"project_morpheus_tpu.{mod}")
    pm = importlib.import_module(f"project_morpheus_tpu_torch.{mod}")
    own = {n for n, v in vars(jm).items() if not n.startswith("_")
           and not isinstance(v, types.ModuleType)
           and getattr(v, "__module__", jm.__name__).startswith("project_morpheus_tpu.")}
    if hasattr(jm, "__all__"):
        own |= set(jm.__all__)
    missing = sorted(n for n in own if not hasattr(pm, n))
    assert not missing, missing
