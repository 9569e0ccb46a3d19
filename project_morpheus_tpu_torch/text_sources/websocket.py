"""WebSocket text source: connect out and yield inbound messages
(reference text_sources/websocket.py:11-30)."""
from __future__ import annotations

from typing import AsyncGenerator


class WebSocketSource:
    def __init__(self, uri: str) -> None:
        self.uri = uri

    async def stream(self) -> AsyncGenerator[str, None]:
        import websockets

        async with websockets.connect(self.uri) as ws:
            async for message in ws:
                if isinstance(message, bytes):
                    message = message.decode("utf-8", errors="replace")
                if message:
                    yield message
