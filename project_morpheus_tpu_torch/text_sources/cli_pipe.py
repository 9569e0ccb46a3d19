"""CLI pipe text source: stream stdin lines via an asyncio reader
(reference text_sources/cli_pipe.py:10-28)."""
from __future__ import annotations

import asyncio
import sys
from typing import AsyncGenerator


class CLIPipeSource:
    def __init__(self, stream=None) -> None:
        self._stream = stream  # injectable for tests

    async def stream(self) -> AsyncGenerator[str, None]:
        if self._stream is not None:
            async for line in self._stream:
                line = line.strip()
                if line:
                    yield line
            return
        loop = asyncio.get_event_loop()
        reader = asyncio.StreamReader()
        protocol = asyncio.StreamReaderProtocol(reader)
        await loop.connect_read_pipe(lambda: protocol, sys.stdin)
        while True:
            raw = await reader.readline()
            if not raw:
                return
            line = raw.decode("utf-8", errors="replace").strip()
            if line:
                yield line
