"""Remote OpenAI-compatible SSE backend with local SNAC decode (port of
adapters/remote_backend.py).

Functional parity with reference tts_engine/remote_backend.py: POSTs a
completion request with ``stream: true`` to ``ORPHEUS_API_URL``, parses
``data:`` SSE lines into token strings (re-splitting merged
``<custom_token_N>`` runs on ``>``), retries transient failures with
exponential backoff, and decodes tokens locally.  Sentence batching for
inputs >= 1000 chars mirrors remote_backend.py:221-240.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import wave
from typing import AsyncGenerator, List, Optional

import httpx
import numpy as np

from ..codec.frames import parse_custom_token
from ..codec.stream_decode import make_stream_decoder
from ..model.sampling import SamplingParams
from ..model.tokenizer import DEFAULT_VOICE
from ..orchestrator.adapter import AudioChunk
from ..utils.text import batch_sentences, split_text_into_sentences
from .runtime import SAMPLE_RATE, get_runtime

API_URL_ENV = "ORPHEUS_API_URL"
DEFAULT_TIMEOUT = float(os.environ.get("ORPHEUS_API_TIMEOUT", "120"))
MAX_RETRIES = 3


def _api_url() -> str:
    url = os.environ.get(API_URL_ENV)
    if not url:
        raise RuntimeError(
            f"{API_URL_ENV} is not set; the remote_sse adapter needs an "
            "OpenAI-compatible completions endpoint"
        )
    return url


async def generate_tokens_from_api(
    prompt: str,
    voice: str = DEFAULT_VOICE,
    sampling: Optional[SamplingParams] = None,
    model: Optional[str] = None,
    client: Optional[httpx.AsyncClient] = None,
) -> AsyncGenerator[str, None]:
    """Stream token strings from the remote endpoint with retry/backoff."""
    sampling = sampling or SamplingParams()
    payload = {
        "prompt": f"<|audio|>{voice}: {prompt}<|eot_id|>",
        "max_tokens": sampling.max_tokens,
        "temperature": sampling.temperature,
        "top_p": sampling.top_p,
        "repeat_penalty": sampling.repetition_penalty,
        "stream": True,
        "model": model or os.environ.get("ORPHEUS_MODEL_NAME", "orpheus"),
    }
    own_client = client is None
    client = client or httpx.AsyncClient(timeout=DEFAULT_TIMEOUT)
    try:
        for attempt in range(MAX_RETRIES):
            try:
                async with client.stream("POST", _api_url(), json=payload) as resp:
                    if resp.status_code >= 500:
                        raise httpx.HTTPStatusError(
                            f"server error {resp.status_code}",
                            request=resp.request,
                            response=resp,
                        )
                    resp.raise_for_status()
                    async for line in resp.aiter_lines():
                        if not line.startswith("data:"):
                            continue
                        data = line[5:].strip()
                        if data == "[DONE]":
                            return
                        try:
                            obj = json.loads(data)
                        except json.JSONDecodeError:
                            continue
                        text = (
                            obj.get("choices", [{}])[0].get("text")
                            or obj.get("choices", [{}])[0]
                            .get("delta", {})
                            .get("content")
                            or ""
                        )
                        # merged custom tokens arrive as one string; re-split
                        # on '>' so each yields one token (reference :117-128)
                        for piece in text.split(">"):
                            if piece:
                                yield piece + ">"
                    return
            except (httpx.TransportError, httpx.HTTPStatusError):
                if attempt == MAX_RETRIES - 1:
                    raise
                await asyncio.sleep(2**attempt)
    finally:
        if own_client:
            await client.aclose()


async def stream_pcm_from_api(
    prompt: str,
    voice: str = DEFAULT_VOICE,
    sampling: Optional[SamplingParams] = None,
    decoder_mode: str = "exact",
    client: Optional[httpx.AsyncClient] = None,
) -> AsyncGenerator[bytes, None]:
    """Tokens -> local SNAC decode -> PCM16 byte hops, batching long text.

    Default decode quality is the exact stateful decoder — the same kernel
    the engine's audio mode uses, so an identical token trace produces
    identical PCM on every path (windowed/parity modes stay for A/B).
    """
    runtime = await get_runtime().ensure()
    decoder = make_stream_decoder(
        runtime.snac_params, runtime.snac_cfg, mode=decoder_mode
    )
    batches = (
        batch_sentences(split_text_into_sentences(prompt))
        if len(prompt) >= 1000
        else [prompt]
    )
    for batch in batches:
        position = 0
        async for token_str in generate_tokens_from_api(
            batch, voice, sampling, client=client
        ):
            code = parse_custom_token(token_str, position)
            if code is None or code <= 0:
                continue
            position += 1
            for hop in decoder.push_tokens([code]):
                yield hop.tobytes()
        for hop in decoder.flush():
            yield hop.tobytes()
        decoder.reset()


async def generate_speech_from_api(
    prompt: str,
    output_file: str,
    voice: str = DEFAULT_VOICE,
    sampling: Optional[SamplingParams] = None,
) -> int:
    """Synthesise ``prompt`` to a WAV file; returns PCM byte count."""
    total = bytearray()
    async for pcm in stream_pcm_from_api(prompt, voice, sampling):
        total.extend(pcm)
    with wave.open(output_file, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(SAMPLE_RATE)
        wf.writeframes(bytes(total))
    return len(total)


class RemoteSSEAdapter:
    """Pull-protocol adapter over the remote SSE stream."""

    name = "remote_sse"

    def __init__(
        self,
        prompt: str,
        voice: str = DEFAULT_VOICE,
        sampling: Optional[SamplingParams] = None,
        max_buffer_bytes: int = 96_000,
        **_: object,
    ) -> None:
        self.prompt = prompt
        self.voice = voice
        self.sampling = sampling
        # pausing the producer stops reading the SSE socket, so backpressure
        # propagates to the remote server via TCP flow control
        self.max_buffer_bytes = max_buffer_bytes
        self._buffer = bytearray()
        self._task: Optional[asyncio.Task] = None
        self._exhausted = False
        self._data = asyncio.Event()
        self._space = asyncio.Event()
        self._space.set()

    async def _produce(self) -> None:
        try:
            async for pcm in stream_pcm_from_api(self.prompt, self.voice, self.sampling):
                self._buffer.extend(pcm)
                self._data.set()
                if len(self._buffer) >= self.max_buffer_bytes:
                    self._space.clear()
                    while len(self._buffer) >= self.max_buffer_bytes:
                        await self._space.wait()
        finally:
            self._exhausted = True
            self._data.set()

    async def pull(self, chunk_size: int) -> AudioChunk:
        if self._task is None and not self._exhausted:
            self._task = asyncio.get_running_loop().create_task(self._produce())
        while len(self._buffer) < chunk_size and not self._exhausted:
            self._data.clear()
            if len(self._buffer) >= chunk_size or self._exhausted:
                continue
            await self._data.wait()
        if not self._buffer and self._exhausted:
            return AudioChunk(pcm=b"", duration_ms=0.0, eos=True)
        n = min(chunk_size, len(self._buffer))
        pcm = bytes(self._buffer[:n])
        del self._buffer[:n]
        if len(self._buffer) < self.max_buffer_bytes:
            self._space.set()
        return AudioChunk(
            pcm=pcm,
            duration_ms=n / 2 / SAMPLE_RATE * 1000.0,
            eos=self._exhausted and not self._buffer,
        )

    async def reset(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        self._task = None
        self._buffer.clear()
        self._exhausted = False
        self._data = asyncio.Event()
        self._space = asyncio.Event()
        self._space.set()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Remote Orpheus SSE client")
    parser.add_argument("text")
    parser.add_argument("--voice", default=DEFAULT_VOICE)
    parser.add_argument("-o", "--out", default="output.wav")
    parser.add_argument("--temperature", type=float, default=0.6)
    parser.add_argument("--top-p", type=float, default=0.9)
    parser.add_argument("--max-tokens", type=int, default=8192)
    args = parser.parse_args(argv)
    sampling = SamplingParams(
        temperature=args.temperature, top_p=args.top_p, max_tokens=args.max_tokens
    )
    n = asyncio.run(
        generate_speech_from_api(args.text, args.out, args.voice, sampling)
    )
    print(f"wrote {args.out} ({n} PCM bytes)")


if __name__ == "__main__":
    main()
