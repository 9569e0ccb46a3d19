"""The port's HTTP server on the CPU: a speech request runs adapter ->
orchestrator -> stitcher over the real (tiny, random-weight) torch engine
and returns a RIFF WAV; voices and stats answer."""
import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from project_morpheus_tpu_torch.adapters import runtime as rt
from project_morpheus_tpu_torch.server.app import create_app, riff_header


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
