"""Local adapter: engine token stream -> streaming SNAC -> pulled bytes
(port of adapters/local_jax.py).

The in-process counterpart of the reference's llama.cpp adapter
(tts_engine/llama_local.py:90-157): ``pull(chunk_size)`` slices an internal
byte buffer fed by the engine's token stream through the streaming SNAC
decoder; ``reset()`` cancels the in-flight request (KV slot eviction) and
drops all buffered audio.  Sentence batching for long inputs happens here,
mirroring inference.py:249-292 semantics.
"""
from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from ..codec.stream_decode import make_stream_decoder
from ..model.sampling import SamplingParams
from ..model.tokenizer import DEFAULT_VOICE, default_tokenizer, format_prompt_ids
from ..orchestrator.adapter import AudioChunk
from ..utils.text import split_text_into_sentences
from .runtime import SAMPLE_RATE, audio_code_from_token_id, get_runtime


class LocalTorchAdapter:
    """Pull-based adapter over the in-process continuous-batching engine."""

    name = "local_torch"

    def __init__(
        self,
        prompt: str,
        voice: str = DEFAULT_VOICE,
        use_batching: bool = False,
        max_batch_chars: int = 1000,
        sampling: Optional[SamplingParams] = None,
        decoder_mode: str = "native",
        max_buffer_bytes: int = 96_000,  # ~2 s of PCM16 @ 24 kHz
    ) -> None:
        self.prompt = prompt
        self.voice = voice
        self.use_batching = use_batching
        self.max_batch_chars = max_batch_chars
        self.sampling = sampling or SamplingParams()
        self.decoder_mode = decoder_mode
        # Backpressure cap: the producer stops draining the engine once this
        # much PCM is buffered, which in turn lets the engine gate the slot
        # (EngineConfig.max_queued_hops) — a stalled client can no longer
        # buffer a whole utterance in RAM (reference pull-pacing,
        # orchestrator/core.py:88-117).
        self.max_buffer_bytes = max_buffer_bytes
        self._buffer = bytearray()
        self._task: Optional[asyncio.Task] = None
        self._requests: List = []
        self._exhausted = False
        self._started = False
        self._data = asyncio.Event()   # set: buffer gained bytes / EOS
        self._space = asyncio.Event()  # set: buffer dropped below the cap
        self._space.set()

    # ------------------------------------------------------------ lifecycle

    def _texts(self) -> List[str]:
        if self.use_batching and len(self.prompt) > self.max_batch_chars:
            return split_text_into_sentences(self.prompt)
        return [self.prompt]

    def _push(self, pcm: bytes) -> None:
        self._buffer.extend(pcm)
        self._data.set()
        if len(self._buffer) >= self.max_buffer_bytes:
            self._space.clear()

    async def _wait_space(self) -> None:
        """Park the producer until the consumer drains below the cap."""
        while len(self._buffer) >= self.max_buffer_bytes:
            await self._space.wait()

    async def _produce(self) -> None:
        """Feed the byte buffer from the engine.

        Prefers engine audio mode (one batched SNAC dispatch per frame
        across all co-batched slots); falls back to per-stream token decode
        for engines without a codec (e.g. the mock backend)."""
        runtime = await get_runtime().ensure()
        engine_audio = getattr(runtime.engine, "supports_audio", False)
        tokenizer = default_tokenizer()
        try:
            for text in self._texts():
                prompt_ids = format_prompt_ids(text, self.voice, tokenizer)
                if engine_audio and self.decoder_mode == "native":
                    req = await runtime.engine.submit(
                        prompt_ids, self.sampling, audio=True
                    )
                    self._requests.append(req)
                    async for pcm in req.pcm_chunks():
                        self._push(pcm)
                        await self._wait_space()
                    continue
                decoder = make_stream_decoder(
                    runtime.snac_params, runtime.snac_cfg, mode=self.decoder_mode
                )
                req = await runtime.engine.submit(prompt_ids, self.sampling)
                self._requests.append(req)
                audio_pos = 0
                async for token_id in req.tokens():
                    code = audio_code_from_token_id(token_id, audio_pos)
                    if code is None:
                        continue
                    audio_pos += 1
                    for hop in decoder.push_tokens([code]):
                        self._push(hop.tobytes())
                    await self._wait_space()
                for hop in decoder.flush():
                    self._push(hop.tobytes())
                decoder.reset()
        except asyncio.CancelledError:
            raise
        except Exception:
            # surfaced again via pull(); log here so a crashed producer is
            # visible even when the client only sees a truncated stream
            logging.getLogger(__name__).exception("synthesis producer failed")
            raise
        finally:
            self._exhausted = True
            self._data.set()

    def _ensure_started(self) -> None:
        if not self._started:
            self._started = True
            self._task = asyncio.get_event_loop().create_task(self._produce())

    # -------------------------------------------------------------- adapter

    async def pull(self, chunk_size: int) -> AudioChunk:
        """Return up to ``chunk_size`` PCM bytes; never block on a full
        utterance (llama_local.py:120-150 contract)."""
        self._ensure_started()
        while len(self._buffer) < chunk_size and not self._exhausted:
            self._data.clear()
            if len(self._buffer) >= chunk_size or self._exhausted:
                continue  # producer ran between the check and the clear
            await self._data.wait()
        if not self._buffer and self._exhausted:
            if self._task is not None:
                await self._task  # surface producer exceptions
            return AudioChunk(pcm=b"", duration_ms=0.0, eos=True)
        n = min(chunk_size, len(self._buffer))
        pcm = bytes(self._buffer[:n])
        del self._buffer[:n]
        if len(self._buffer) < self.max_buffer_bytes:
            self._space.set()
        duration_ms = n / 2 / SAMPLE_RATE * 1000.0
        eos = self._exhausted and not self._buffer
        return AudioChunk(pcm=pcm, duration_ms=duration_ms, eos=eos)

    async def reset(self) -> None:
        """Barge-in: cancel in-flight requests and drop buffered audio."""
        runtime = get_runtime()
        for req in self._requests:
            if runtime.engine is not None:
                runtime.engine.cancel(req)
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        self._requests.clear()
        self._buffer.clear()
        self._task = None
        self._started = False
        self._exhausted = False
        self._data = asyncio.Event()
        self._space = asyncio.Event()
        self._space.set()
