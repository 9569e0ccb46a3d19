"""HTTP/WS API server (port of server/app.py).

Route surface (parity with reference server.py:365-381):

    POST /v1/audio/speech   OpenAI-style synthesis -> streaming WAV
    GET  /v1/audio/voices   voice & language tables
    WS   /ws/tts            text frames in -> binary PCM frames out
    GET  /adapters          adapter capability descriptors
    GET  /sources           text-source descriptors
    GET  /config            merged runtime config
    POST /config            validated mutation + hot swap + barge-in
    GET  /stats             orchestrator timeline/transcripts
    POST /barge-in          interrupt current utterance
    WS   /ws/barge-in       same, via websocket message
    GET  /admin             static dashboard

Run on the card with ``python -m project_morpheus_tpu_torch.server.app``
(``--device cpu`` for the CPU).

Streaming WAV uses a RIFF header with 0xFFFFFFFF placeholder lengths so
clients can play while bytes arrive (reference server.py:50-69).
"""
from __future__ import annotations

import asyncio
import json
import logging
import struct
from pathlib import Path
from typing import Optional

from aiohttp import WSMsgType, web

from .. import config as config_mod
from ..adapters import VoiceSchema, registry as adapter_registry
from ..adapters.runtime import SAMPLE_RATE, ServingRuntime, set_runtime
from ..model.sampling import SamplingParams
from ..model.tokenizer import AVAILABLE_VOICES, DEFAULT_VOICE
from ..orchestrator import (
    ChunkLadder,
    Orchestrator,
    PlaybackBuffer,
    stitch_chunks,
)
from ..text_sources import registry as source_registry

logger = logging.getLogger(__name__)

ADMIN_DIR = Path(__file__).parent / "admin"


def riff_header(sample_rate: int = SAMPLE_RATE) -> bytes:
    """Streaming WAV header with unknown (0xFFFFFFFF) lengths."""
    byte_rate = sample_rate * 2
    return b"RIFF" + struct.pack(
        "<I4s4sIHHIIHH4sI",
        0xFFFFFFFF,
        b"WAVE",
        b"fmt ",
        16,
        1,  # PCM
        1,  # mono
        sample_rate,
        byte_rate,
        2,  # block align
        16,  # bits
        b"data",
        0xFFFFFFFF,
    )


class SpeedResampler:
    """Streaming linear-interpolation time stretch for int16 PCM.

    Implements the OpenAI-style ``speed`` field of the speech request
    (reference accepts it in its schema, server.py:161-166, but never
    applies it; here speed 2.0 really halves the duration).  Keeps the
    last input sample and the fractional read phase across chunks so the
    output is continuous at chunk boundaries.
    """

    def __init__(self, speed: float) -> None:
        self.speed = float(speed)
        self._prev = None  # last input sample (1-element array)
        self._in0 = 0      # global input index of the buffered sample
        self._emitted = 0  # output samples emitted so far

    def process(self, pcm: bytes) -> bytes:
        import numpy as np

        x = np.frombuffer(pcm, np.int16)
        if x.size == 0:
            return b""
        if self._prev is not None:
            x = np.concatenate([self._prev, x])
        # output sample k reads global input position k*speed; integer
        # bookkeeping keeps chunked processing bit-identical to one-shot
        last_global = self._in0 + x.size - 1
        n = int(np.floor(last_global / self.speed)) - self._emitted + 1
        self._prev = x[-1:]
        if n <= 0:
            self._in0 = last_global
            return b""
        pos = (self._emitted + np.arange(n)) * self.speed - self._in0
        out = np.interp(pos, np.arange(x.size), x.astype(np.float32))
        self._emitted += n
        self._in0 = last_global
        return out.astype(np.int16).tobytes()


class ServerState:
    """Mutable serving state (reference server.py:90-96)."""

    def __init__(self, generation: Optional[dict] = None) -> None:
        self.adapter_name = "local_torch"
        self.voice = DEFAULT_VOICE
        self.orchestrator: Optional[Orchestrator] = None
        self.source_name: Optional[str] = None
        self.source_task: Optional[asyncio.Task] = None
        self.generation = {
            "temperature": 0.6,
            "top_p": 0.9,
            "max_tokens": 8192,
        }
        self.generation.update(generation or {})


STATE = web.AppKey("state", ServerState)


def _sampling(state: ServerState) -> SamplingParams:
    g = state.generation
    return SamplingParams(
        temperature=float(g["temperature"]),
        top_p=float(g["top_p"]),
        max_tokens=int(g["max_tokens"]),
    )


async def orchestrated_pcm_stream(state: ServerState, text: str, voice: str,
                                  use_batching: bool = False):
    """Build adapter -> orchestrator -> stitcher for one utterance
    (reference server.py:127-159)."""
    adapter = adapter_registry.create(
        state.adapter_name,
        prompt=text,
        voice=VoiceSchema(voice=voice),
        use_batching=use_batching,
        sampling=_sampling(state),
    )
    orch = Orchestrator(adapter, PlaybackBuffer(capacity_ms=1000.0), ChunkLadder())
    state.orchestrator = orch
    orch.log_transcript(text)
    async for chunk in stitch_chunks(
        orch.stream(), sample_rate=SAMPLE_RATE, overlap_ms=0.0
    ):
        if chunk.pcm:
            yield chunk.pcm
        if chunk.eos:
            break


# ------------------------------------------------------------------ handlers


async def create_speech(request: web.Request) -> web.StreamResponse:
    state: ServerState = request.app[STATE]
    try:
        body = await request.json()
    except json.JSONDecodeError:
        raise web.HTTPBadRequest(text="invalid JSON body")
    text = body.get("input")
    if not text or not isinstance(text, str):
        raise web.HTTPBadRequest(text="missing 'input'")
    voice = body.get("voice") or state.voice
    response_format = body.get("response_format", "wav")
    if response_format not in ("wav", "pcm"):
        raise web.HTTPBadRequest(text=f"unsupported response_format {response_format!r}")
    try:
        speed = float(body.get("speed", 1.0))
    except (TypeError, ValueError):
        raise web.HTTPBadRequest(text="'speed' must be a number")
    if not (0.25 <= speed <= 4.0):
        raise web.HTTPBadRequest(text="'speed' must be in [0.25, 4.0]")
    use_batching = len(text) > 1000  # reference server.py:180-186

    resp = web.StreamResponse(
        headers={
            "Content-Type": "audio/wav" if response_format == "wav" else "audio/pcm",
            "Cache-Control": "no-store",
        }
    )
    await resp.prepare(request)
    if response_format == "wav":
        await resp.write(riff_header())
    stretch = SpeedResampler(speed) if speed != 1.0 else None
    try:
        async for pcm in orchestrated_pcm_stream(state, text, voice, use_batching):
            if stretch is not None:
                pcm = stretch.process(pcm)
            if pcm:
                await resp.write(pcm)
    except ConnectionResetError:
        if state.orchestrator is not None:
            state.orchestrator.signal_barge_in()
    await resp.write_eof()
    return resp


async def list_voices(request: web.Request) -> web.Response:
    return web.json_response(
        {
            "voices": [v for vs in AVAILABLE_VOICES.values() for v in vs],
            "voices_by_language": AVAILABLE_VOICES,
            "default": DEFAULT_VOICE,
        }
    )


async def ws_tts(request: web.Request) -> web.WebSocketResponse:
    state: ServerState = request.app[STATE]
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    async for msg in ws:
        if msg.type != WSMsgType.TEXT:
            continue
        try:
            payload = json.loads(msg.data)
            text = payload.get("input") or payload.get("text")
            voice = payload.get("voice") or state.voice
        except json.JSONDecodeError:
            text, voice = msg.data, state.voice
        if not text:
            continue
        async for pcm in orchestrated_pcm_stream(state, text, voice):
            await ws.send_bytes(pcm)
        await ws.send_json({"eos": True})
    return ws


async def list_adapters(request: web.Request) -> web.Response:
    return web.json_response(adapter_registry.available())


async def list_sources(request: web.Request) -> web.Response:
    return web.json_response(source_registry.available())


async def get_config(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    cfg = config_mod.get_current_config()
    cfg.update(
        {
            "adapter": state.adapter_name,
            "voice": state.voice,
            "source": state.source_name,
            **{k.upper(): str(v) for k, v in state.generation.items()},
        }
    )
    return web.json_response(cfg)


async def _consume_source(state: ServerState, source) -> None:
    """Continuous mode: synthesise each pushed line (server.py:99-108)."""
    try:
        async for text in source.stream():
            async for _ in orchestrated_pcm_stream(state, text, state.voice):
                pass
    except asyncio.CancelledError:
        raise
    except Exception:
        logger.exception("text source failed")


async def update_config(request: web.Request) -> web.Response:
    """Validated runtime mutation (reference server.py:243-332)."""
    state: ServerState = request.app[STATE]
    try:
        body = await request.json()
    except json.JSONDecodeError:
        raise web.HTTPBadRequest(text="invalid JSON body")

    errors = []
    persist: dict = {}

    temp = body.get("temperature")
    if temp is not None:
        if not (0.1 <= float(temp) <= 1.5):
            errors.append("temperature must be in [0.1, 1.5]")
        else:
            state.generation["temperature"] = float(temp)
            persist["ORPHEUS_TEMPERATURE"] = float(temp)
    top_p = body.get("top_p")
    if top_p is not None:
        if not (0.0 < float(top_p) <= 1.0):
            errors.append("top_p must be in (0, 1]")
        else:
            state.generation["top_p"] = float(top_p)
            persist["ORPHEUS_TOP_P"] = float(top_p)
    max_tokens = body.get("max_tokens")
    if max_tokens is not None:
        if not (1 <= int(max_tokens) <= 200_000):
            errors.append("max_tokens must be in [1, 200000]")
        else:
            state.generation["max_tokens"] = int(max_tokens)
            persist["ORPHEUS_MAX_TOKENS"] = int(max_tokens)

    adapter = body.get("adapter")
    if adapter is not None:
        if adapter not in adapter_registry.names():
            errors.append(f"unknown adapter {adapter!r}")
        else:
            state.adapter_name = adapter
    voice = body.get("voice")
    if voice is not None:
        state.voice = voice

    source = body.get("source")
    if source is not None:
        if source not in source_registry.names():
            errors.append(f"unknown source {source!r}")
        else:
            if state.source_task is not None:
                state.source_task.cancel()
                state.source_task = None
            src = source_registry.create(source, **(body.get("source_config") or {}))
            state.source_name = source
            state.source_task = asyncio.get_running_loop().create_task(
                _consume_source(state, src)
            )

    if errors:
        return web.json_response({"errors": errors}, status=400)

    # any accepted change interrupts the current utterance (server.py:308-309)
    if state.orchestrator is not None and (adapter or voice or persist):
        state.orchestrator.signal_barge_in()
    if persist:
        config_mod.save_config(persist)
    return web.json_response({"ok": True, "applied": list(body)})


async def stats(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    orch = state.orchestrator
    return web.json_response(
        {
            "adapter": state.adapter_name,
            "voice": state.voice,
            "timeline": orch.timeline if orch else [],
            "transcripts": orch.transcripts if orch else [],
            "generation": state.generation,
        }
    )


async def barge_in(request: web.Request) -> web.Response:
    state: ServerState = request.app[STATE]
    if state.orchestrator is not None:
        state.orchestrator.signal_barge_in()
        return web.json_response({"ok": True})
    return web.json_response({"ok": False, "reason": "no active stream"})


async def ws_barge_in(request: web.Request) -> web.WebSocketResponse:
    state: ServerState = request.app[STATE]
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    async for msg in ws:
        if msg.type == WSMsgType.TEXT:
            if state.orchestrator is not None:
                state.orchestrator.signal_barge_in()
            await ws.send_json({"ok": True})
    return ws


async def admin_index(request: web.Request) -> web.Response:
    index = ADMIN_DIR / "index.html"
    return web.Response(text=index.read_text(encoding="utf-8"), content_type="text/html")


async def _stop_source(app: web.Application) -> None:
    task = app[STATE].source_task
    if task is not None:
        task.cancel()


# --------------------------------------------------------------------- app


def create_app(generation: Optional[dict] = None) -> web.Application:
    """The app; ``generation`` overrides the default sampling settings."""
    app = web.Application()
    app[STATE] = ServerState(generation)
    app.router.add_post("/v1/audio/speech", create_speech)
    app.router.add_get("/v1/audio/voices", list_voices)
    app.router.add_get("/ws/tts", ws_tts)
    app.router.add_get("/adapters", list_adapters)
    app.router.add_get("/sources", list_sources)
    app.router.add_get("/config", get_config)
    app.router.add_post("/config", update_config)
    app.router.add_get("/stats", stats)
    app.router.add_post("/barge-in", barge_in)
    app.router.add_get("/ws/barge-in", ws_barge_in)
    app.router.add_get("/admin", admin_index)
    app.router.add_static("/admin/", ADMIN_DIR)
    app.on_cleanup.append(_stop_source)
    return app


def start_server(host: Optional[str] = None, port: Optional[int] = None) -> None:
    """Serve ``create_app()`` until interrupted, on ``ORPHEUS_HOST`` /
    ``ORPHEUS_PORT`` (config.py) unless given; the runtime is the one
    ``set_runtime`` installed, else the default (on the card)."""
    cfg = config_mod.get_current_config()
    web.run_app(create_app(), host=host or cfg["ORPHEUS_HOST"],
                port=int(port or cfg["ORPHEUS_PORT"]))


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default=None, help="default: ORPHEUS_HOST (config.py)")
    p.add_argument("--port", type=int, default=None, help="default: ORPHEUS_PORT (config.py)")
    p.add_argument("--device", default="cuda",
                   help="device the engine runs on (cuda unless cpu is asked for)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    set_runtime(ServingRuntime(device=args.device))
    start_server(args.host, args.port)


if __name__ == "__main__":
    main()
