"""HTTP API server (port of server/app.py).

Routes ported so far (the WS, config, barge-in, sources and admin routes
of the JAX server are not):

    POST /v1/audio/speech   OpenAI-style synthesis -> streaming WAV
    GET  /v1/audio/voices   voice & language tables
    GET  /stats             orchestrator timeline/transcripts

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
from typing import Optional

from aiohttp import web

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

logger = logging.getLogger(__name__)


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


# --------------------------------------------------------------------- app


def create_app(generation: Optional[dict] = None) -> web.Application:
    """The app; ``generation`` overrides the default sampling settings."""
    app = web.Application()
    app[STATE] = ServerState(generation)
    app.router.add_post("/v1/audio/speech", create_speech)
    app.router.add_get("/v1/audio/voices", list_voices)
    app.router.add_get("/stats", stats)
    return app


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5005)
    p.add_argument("--device", default="cuda",
                   help="device the engine runs on (cuda unless cpu is asked for)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    set_runtime(ServingRuntime(device=args.device))
    web.run_app(create_app(), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
