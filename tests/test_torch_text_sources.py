"""The port's text sources (project_morpheus_tpu_torch.text_sources) mirror
``tests/test_text_sources.py``: registry descriptors (equal to the JAX
package's), HTTP poll until an empty body, a websocket server, the CLI
pipe, creation by name."""
import asyncio

import httpx

from project_morpheus_tpu.text_sources import registry as jax_registry
from project_morpheus_tpu_torch.text_sources import (
    CLIPipeSource,
    HTTPPollingSource,
    WebSocketSource,
    registry,
)


def test_registry_descriptors_match_jax():
    av = registry.available()
    assert set(av) == {"websocket", "http_poll", "cli_pipe"}
    assert av["http_poll"]["config"] == ["url", "interval_s"]
    assert av == jax_registry.available()


def test_http_poll_until_empty():
    bodies = ["first", "second", ""]

    def handler(request):
        return httpx.Response(200, text=bodies.pop(0))

    async def go():
        client = httpx.AsyncClient(transport=httpx.MockTransport(handler))
        src = HTTPPollingSource("http://fake/feed", interval_s=0.0, client=client)
        out = [t async for t in src.stream()]
        await client.aclose()
        return out

    assert asyncio.run(go()) == ["first", "second"]


def test_websocket_source_real_server():
    import websockets

    async def go():
        async def echo(ws):
            await ws.send("hello")
            await ws.send(b"world")
            await ws.close()

        async with websockets.serve(echo, "127.0.0.1", 0) as server:
            port = server.sockets[0].getsockname()[1]
            src = WebSocketSource(f"ws://127.0.0.1:{port}")
            return [t async for t in src.stream()]

    assert asyncio.run(go()) == ["hello", "world"]


def test_cli_pipe_with_injected_stream():
    async def fake_lines():
        for line in ["one\n", "  \n", "two\n"]:
            yield line

    async def go():
        src = CLIPipeSource(stream=fake_lines())
        return [t async for t in src.stream()]

    assert asyncio.run(go()) == ["one", "two"]


def test_create_by_name():
    src = registry.create("http_poll", url="http://x", interval_s=2.0)
    assert isinstance(src, HTTPPollingSource)
    assert src.interval_s == 2.0
    assert isinstance(registry.create("cli_pipe"), CLIPipeSource)
