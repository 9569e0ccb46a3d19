"""The port's HTTP server on the CPU: a speech request runs adapter ->
orchestrator -> stitcher over the real (tiny, random-weight) torch engine
and returns a RIFF WAV; voices and stats answer; the routes of the JAX
server (``/ws/tts``, ``/adapters``, ``/sources``, ``/config``,
``/barge-in``, ``/ws/barge-in``, ``/admin``) with the mock engine and the
tiny engine, as ``tests/test_server.py`` drives them."""
import asyncio
import json

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from project_morpheus_tpu_torch.adapters import runtime as rt
from project_morpheus_tpu_torch.server.app import STATE, create_app, riff_header


@pytest.fixture
def tiny_runtime(monkeypatch):
    monkeypatch.setenv("ORPHEUS_MODEL_SIZE", "tiny")
    monkeypatch.delenv("ORPHEUS_QUANT", raising=False)
    monkeypatch.delenv("ORPHEUS_KV_QUANT", raising=False)
    monkeypatch.setenv("ORPHEUS_MAX_SLOTS", "2")
    monkeypatch.setenv("ORPHEUS_MAX_SEQ", "256")
    # banded sampling keeps random weights on audio codes, so 28 tokens
    # make four full frames
    runtime = rt.ServingRuntime(device="cpu", banded_sampling=True)
    rt.set_runtime(runtime)
    yield runtime
    rt.set_runtime(None)


def _with_client(fn, runtime):
    async def go():
        client = TestClient(TestServer(create_app(generation={"max_tokens": 28})))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()
            if runtime.engine is not None:
                await runtime.engine.close()

    return asyncio.run(go())


def test_speech_returns_riff_wav(tiny_runtime):
    async def fn(client):
        resp = await client.post("/v1/audio/speech", json={"input": "hello world"})
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "audio/wav"
        return await resp.read()

    body = _with_client(fn, tiny_runtime)
    assert body[:44] == riff_header()
    pcm = np.frombuffer(body[44:], np.int16)
    assert pcm.size >= 4 * tiny_runtime.snac_cfg.frame_samples


def test_voices_and_stats(tiny_runtime):
    async def fn(client):
        voices = await (await client.get("/v1/audio/voices")).json()
        stats = await (await client.get("/stats")).json()
        bad = await client.post("/v1/audio/speech", json={"voice": "tara"})
        return voices, stats, bad.status

    voices, stats, bad = _with_client(fn, tiny_runtime)
    assert "tara" in voices["voices"] and voices["default"] == "tara"
    assert stats["adapter"] == "local_torch" and stats["timeline"] == []
    assert bad == 400


# ------------------------------------------------ routes of the JAX server


@pytest.fixture
def mock_runtime(monkeypatch, tmp_path):
    """Mock engine (audio-band tokens, no model); config writes land in
    ``tmp_path``, and the keys they set in os.environ are restored."""
    monkeypatch.setenv("ORPHEUS_ENGINE_MODE", "mock")
    monkeypatch.setenv("ORPHEUS_MODEL_SIZE", "tiny")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    from project_morpheus_tpu_torch import config as config_mod

    monkeypatch.setattr(config_mod, "HOME_CONFIG", tmp_path / ".morpheus_tpu" / "config")
    for key in ("ORPHEUS_TEMPERATURE", "ORPHEUS_TOP_P", "ORPHEUS_MAX_TOKENS"):
        monkeypatch.delenv(key, raising=False)
    runtime = rt.ServingRuntime(device="cpu")
    rt.set_runtime(runtime)
    yield runtime
    rt.set_runtime(None)


async def _ws_utterance(client, text):
    ws = await client.ws_connect("/ws/tts")
    await ws.send_str(json.dumps({"input": text}))
    frames, eos = [], None
    async for msg in ws:
        if msg.type.name == "BINARY":
            frames.append(msg.data)
        elif msg.type.name == "TEXT":
            eos = json.loads(msg.data)
            break
    await ws.close()
    return frames, eos


def test_adapters_sources_and_admin(mock_runtime):
    async def fn(client):
        a = await (await client.get("/adapters")).json()
        s = await (await client.get("/sources")).json()
        admin = await client.get("/admin")
        return a, s, admin.status, await admin.text()

    adapters, sources, status, html = _with_client(fn, mock_runtime)
    assert set(adapters) == {"local_torch", "remote_sse"}
    assert adapters["local_torch"]["supports_barge_in"] is True
    assert set(sources) == {"websocket", "http_poll", "cli_pipe"}
    assert status == 200 and "<html" in html.lower()


def test_config_roundtrip_validation_and_swap(mock_runtime, tmp_path):
    async def fn(client):
        bad = await client.post("/config", json={"temperature": 9.0})
        ok = await client.post("/config", json={"temperature": 0.7, "top_p": 0.8,
                                                "max_tokens": 100})
        swap = await client.post("/config", json={"adapter": "remote_sse", "voice": "leo"})
        unknown = await client.post("/config", json={"adapter": "nope", "source": "nope"})
        cfg = await (await client.get("/config")).json()
        return (bad.status, await bad.json(), ok.status, swap.status, unknown.status,
                await unknown.json(), cfg)

    bad, bad_body, ok, swap, unknown, unknown_body, cfg = _with_client(fn, mock_runtime)
    assert bad == 400 and "temperature" in bad_body["errors"][0]
    assert ok == 200 and swap == 200 and unknown == 400 and len(unknown_body["errors"]) == 2
    assert cfg["TEMPERATURE"] == "0.7" and cfg["MAX_TOKENS"] == "100"
    assert cfg["ORPHEUS_TEMPERATURE"] == "0.7"  # persisted to the env layer
    assert cfg["adapter"] == "remote_sse" and cfg["voice"] == "leo"
    assert cfg["ORPHEUS_ENGINE_MODE"] == "mock"
    assert "ORPHEUS_TEMPERATURE=0.7" in (tmp_path / ".env").read_text()


def test_ws_tts_stats_and_barge_in(mock_runtime):
    async def fn(client):
        none_yet = await (await client.post("/barge-in")).json()
        frames, eos = await _ws_utterance(client, "hello ws")
        st = await (await client.get("/stats")).json()
        ok = await (await client.post("/barge-in")).json()
        ws = await client.ws_connect("/ws/barge-in")
        await ws.send_str("stop")
        ws_ok = await ws.receive_json()
        await ws.close()
        return none_yet, frames, eos, st, ok, ws_ok

    none_yet, frames, eos, st, ok, ws_ok = _with_client(fn, mock_runtime)
    assert none_yet["ok"] is False and ok["ok"] is True and ws_ok == {"ok": True}
    assert eos == {"eos": True}
    # max_tokens 28: four frames of PCM16
    assert sum(len(f) for f in frames) == 4 * 2 * mock_runtime.snac_cfg.frame_samples
    assert st["transcripts"][0]["text"] == "hello ws"
    assert any(e["stage"] == "adapter_pull" for e in st["timeline"])


def test_config_change_barges_in(mock_runtime):
    """An accepted POST /config while an utterance streams interrupts it."""
    async def fn(client):
        resp = await client.post("/v1/audio/speech", json={"input": "a long utterance"})
        await resp.content.read(44 + 4096)
        state = client.server.app[STATE]
        orch = state.orchestrator
        r = await client.post("/config", json={"temperature": 0.9})
        await resp.read()
        return r.status, orch, state.generation["temperature"]

    status, orch, temp = _with_client(fn, mock_runtime)
    assert status == 200 and temp == 0.9
    # signalled: either still pending, or the orchestrator already reset on it
    assert orch._barge_in.is_set() or any(e["stage"] == "barge_in_reset" for e in orch.timeline)


def test_ws_tts_on_tiny_engine(tiny_runtime):
    async def fn(client):
        return await _ws_utterance(client, "hello there")

    frames, eos = _with_client(fn, tiny_runtime)
    assert eos == {"eos": True}
    assert sum(len(f) for f in frames) >= 4 * 2 * tiny_runtime.snac_cfg.frame_samples
