"""The port's ``Client`` (httpx for REST, websockets for ``/ws/tts``)
against the port's server, in process on a localhost port: the same
calls the JAX client makes, and the same bytes as the server's own
routes."""
import asyncio
import threading

import pytest
from aiohttp.test_utils import TestServer

import project_morpheus_tpu.server as jax_server
import project_morpheus_tpu_torch.server as server
from project_morpheus_tpu_torch.adapters import runtime as rt
from project_morpheus_tpu_torch.server import Client, create_app
from project_morpheus_tpu_torch.server.app import riff_header


@pytest.fixture
def mock_runtime(monkeypatch, tmp_path):
    monkeypatch.setenv("ORPHEUS_ENGINE_MODE", "mock")
    monkeypatch.setenv("ORPHEUS_MODEL_SIZE", "tiny")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    for key in ("ORPHEUS_TEMPERATURE", "ORPHEUS_TOP_P", "ORPHEUS_MAX_TOKENS"):
        monkeypatch.delenv(key, raising=False)
    runtime = rt.ServingRuntime(device="cpu")
    rt.set_runtime(runtime)
    yield runtime
    rt.set_runtime(None)


def _serve(fn, runtime, max_tokens=28):
    """Serve on an event loop of its own in a thread, as a separate server
    process would (the engine computes inside the server's loop, so a
    shared loop would stall the client's timeouts and pings); the runtime is
    built before the client connects."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def start():
        await runtime.ensure()
        srv = TestServer(create_app(generation={"max_tokens": max_tokens}))
        await srv.start_server()
        return srv

    async def stop(srv):
        await srv.close()
        if runtime.engine is not None:
            await runtime.engine.close()

    srv = asyncio.run_coroutine_threadsafe(start(), loop).result(timeout=300)
    try:
        return asyncio.run(fn(Client(str(srv.make_url("")).rstrip("/") + "/")))
    finally:
        asyncio.run_coroutine_threadsafe(stop(srv), loop).result(timeout=120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


def test_exports_match_jax():
    assert set(server.__all__) == set(jax_server.__all__) == {"create_app", "start_server", "Client"}
    assert callable(server.start_server)
    jax_api = {n for n in dir(jax_server.Client) if not n.startswith("_")}
    assert jax_api <= {n for n in dir(Client) if not n.startswith("_")}


def test_rest_and_ws_streams_carry_the_same_pcm(mock_runtime):
    async def fn(client):
        rest = b"".join([c async for c in client.stream_rest("hello client", voice="tara")])
        ws = [f async for f in client.stream_ws("hello client", voice="tara")]
        return rest, ws

    rest, ws = _serve(fn, mock_runtime)
    assert rest[:44] == riff_header()
    # max_tokens 28: four frames
    assert len(rest) - 44 == 4 * 2 * mock_runtime.snac_cfg.frame_samples
    assert b"".join(ws) == rest[44:]


def test_voices_stats_and_barge_in(mock_runtime):
    async def fn(client):
        voices = await client.voices()
        none_yet = await client.barge_in()
        stream = client.stream_rest("an utterance to interrupt")
        first = await stream.__anext__()
        interrupted = await client.barge_in()
        rest = [c async for c in stream]
        stats = await client.stats()
        return voices, none_yet, first, interrupted, rest, stats

    voices, none_yet, first, interrupted, rest, stats = _serve(fn, mock_runtime)
    assert "tara" in voices["voices"] and voices["default"] == "tara"
    assert none_yet is False and interrupted is True
    assert first[:4] == b"RIFF"
    assert stats["adapter"] == "local_torch"
    assert stats["timeline"]


def test_speak_plays_pcm_without_the_header(mock_runtime, monkeypatch):
    from project_morpheus_tpu_torch.utils import playback

    monkeypatch.setattr(playback, "_sd", None)  # headless: bytes are counted

    async def fn(client):
        played = await client.speak("hello speaker")
        body = b"".join([c async for c in client.stream_rest("hello speaker")])
        return played, body

    played, body = _serve(fn, mock_runtime)
    assert played == len(body) - 44 == 4 * 2 * mock_runtime.snac_cfg.frame_samples
