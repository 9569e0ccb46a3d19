"""Python client SDK (port of server/client.py; reference
Morpheus_Client/client.py:14-40): REST through ``httpx``, ``/ws/tts``
through ``websockets``."""
from __future__ import annotations

import json
from typing import AsyncGenerator, Optional

import httpx


class Client:
    """Stream synthesis over REST (chunked WAV) or WebSocket (PCM frames)."""

    def __init__(self, base_url: str = "http://127.0.0.1:5005") -> None:
        self.base_url = base_url.rstrip("/")

    async def stream_rest(
        self, text: str, voice: Optional[str] = None, **kwargs
    ) -> AsyncGenerator[bytes, None]:
        payload = {"input": text}
        if voice:
            payload["voice"] = voice
        payload.update(kwargs)
        async with httpx.AsyncClient(timeout=None) as client:
            async with client.stream(
                "POST", f"{self.base_url}/v1/audio/speech", json=payload
            ) as resp:
                resp.raise_for_status()
                async for chunk in resp.aiter_bytes():
                    yield chunk

    async def stream_ws(
        self, text: str, voice: Optional[str] = None
    ) -> AsyncGenerator[bytes, None]:
        import websockets

        uri = self.base_url.replace("http", "ws", 1) + "/ws/tts"
        async with websockets.connect(uri) as ws:
            await ws.send(json.dumps({"input": text, "voice": voice}))
            async for message in ws:
                if isinstance(message, bytes):
                    yield message
                else:
                    try:
                        if json.loads(message).get("eos"):
                            return
                    except json.JSONDecodeError:
                        continue

    async def speak(self, text: str, voice: Optional[str] = None) -> int:
        """Stream synthesis to the LOCAL audio device (optional PortAudio
        peripheral, reference inference.py:226-242); returns bytes played.
        Headless environments count bytes but stay silent."""
        from ..utils.playback import LocalPlayback

        player = LocalPlayback()
        try:
            # the transport may split the 44-byte RIFF header across
            # chunks (or deliver a sub-44-byte first chunk); buffer until
            # the header decision can be made so no header bytes ever
            # reach the playback stream as PCM noise
            head = bytearray()
            deciding = True
            async for chunk in self.stream_rest(text, voice):
                if deciding:
                    head.extend(chunk)
                    if len(head) < 44:
                        continue
                    deciding = False
                    chunk = bytes(head[44:] if head[:4] == b"RIFF" else head)
                    if not chunk:
                        continue
                player.play(chunk)
            if deciding and head:  # short non-WAV stream: play what arrived
                player.play(bytes(head[44:] if head[:4] == b"RIFF" else head))
            return player.bytes_played
        finally:
            player.close()

    async def barge_in(self) -> bool:
        async with httpx.AsyncClient() as client:
            resp = await client.post(f"{self.base_url}/barge-in")
            return resp.json().get("ok", False)

    async def voices(self) -> dict:
        async with httpx.AsyncClient() as client:
            return (await client.get(f"{self.base_url}/v1/audio/voices")).json()

    async def stats(self) -> dict:
        async with httpx.AsyncClient() as client:
            return (await client.get(f"{self.base_url}/stats")).json()
