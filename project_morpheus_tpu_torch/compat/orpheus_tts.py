"""Drop-in facade mirroring the ``orpheus_tts`` pypi package API (port of
compat/orpheus_tts.py).

Reference surface (Orpheus-TTS/orpheus_tts_pypi/orpheus_tts/engine_class.py):
``OrpheusModel(model_name, **engine_kwargs)`` with ``generate_speech(...)``
yielding PCM16 byte chunks synchronously and ``generate_tokens_sync(...)``
yielding token strings.  Here the vLLM engine is replaced by the in-process
continuous-batching engine + streaming SNAC decode; the sync generators
bridge the asyncio engine through a background loop thread exactly where
the reference bridges vLLM's async engine through a daemon thread + queue
(engine_class.py:103-134).
"""
from __future__ import annotations

import asyncio
import queue
import threading
from typing import Generator, Iterable, Optional

from ..adapters.runtime import audio_code_from_token_id, get_runtime
from ..codec.frames import custom_number_from_audio_code
from ..codec.stream_decode import ExactStreamDecoder
from ..model.sampling import SamplingParams
from ..model.tokenizer import DEFAULT_VOICE, default_tokenizer, format_prompt_ids


class OrpheusModel:
    """Synchronous facade over the serving runtime."""

    def __init__(self, model_name: str = "orpheus-torch", **engine_kwargs) -> None:
        self.model_name = model_name
        self.engine_kwargs = engine_kwargs
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    # ------------------------------------------------------------- tokens

    def generate_tokens_sync(
        self,
        prompt: str,
        voice: Optional[str] = DEFAULT_VOICE,
        request_id: str = "req-001",
        temperature: float = 0.6,
        top_p: float = 0.8,
        max_tokens: int = 1200,
        stop_token_ids: Iterable[int] = (49158,),
        repetition_penalty: float = 1.3,
    ) -> Generator[str, None, None]:
        """Yield ``<custom_token_N>`` strings (reference string contract)."""
        out: "queue.Queue[Optional[str]]" = queue.Queue()

        async def produce():
            runtime = await get_runtime().ensure()
            ids = format_prompt_ids(prompt, voice, default_tokenizer())
            sampling = SamplingParams(
                temperature=temperature,
                top_p=top_p,
                max_tokens=max_tokens,
                repetition_penalty=repetition_penalty,
                stop_token_ids=tuple(stop_token_ids),
            )
            req = await runtime.engine.submit(ids, sampling)
            pos = 0
            async for token_id in req.tokens():
                code = audio_code_from_token_id(token_id, pos)
                if code is None:
                    continue
                out.put(f"<custom_token_{custom_number_from_audio_code(code, pos)}>")
                pos += 1
            out.put(None)

        fut = self._run(produce())
        while True:
            tok = out.get()
            if tok is None:
                break
            yield tok
        fut.result()

    # -------------------------------------------------------------- audio

    def generate_speech(self, **kwargs) -> Generator[bytes, None, None]:
        """Yield PCM16 byte chunks (reference engine_class.py:136-137)."""
        out: "queue.Queue[Optional[bytes]]" = queue.Queue()
        prompt = kwargs.pop("prompt")
        voice = kwargs.pop("voice", DEFAULT_VOICE)

        async def produce():
            runtime = await get_runtime().ensure()
            ids = format_prompt_ids(prompt, voice, default_tokenizer())
            sampling = SamplingParams(
                temperature=kwargs.get("temperature", 0.6),
                top_p=kwargs.get("top_p", 0.8),
                max_tokens=kwargs.get("max_tokens", 1200),
                repetition_penalty=kwargs.get("repetition_penalty", 1.3),
                stop_token_ids=tuple(kwargs.get("stop_token_ids", (128258,))),
            )
            req = await runtime.engine.submit(ids, sampling)
            # exact stateful decode: identical PCM to the engine audio path
            decoder = ExactStreamDecoder(runtime.snac_params, runtime.snac_cfg)
            pos = 0
            async for token_id in req.tokens():
                code = audio_code_from_token_id(token_id, pos)
                if code is None:
                    continue
                pos += 1
                for hop in decoder.push_tokens([code]):
                    out.put(hop.tobytes())
            for hop in decoder.flush():
                out.put(hop.tobytes())
            out.put(None)

        fut = self._run(produce())
        while True:
            chunk = out.get()
            if chunk is None:
                break
            yield chunk
        fut.result()

    def close(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)
