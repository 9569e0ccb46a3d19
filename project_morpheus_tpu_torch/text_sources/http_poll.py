"""HTTP polling text source: GET until an empty body signals exhaustion
(reference text_sources/http_poll.py:11-33)."""
from __future__ import annotations

import asyncio
from typing import AsyncGenerator, Optional

import httpx


class HTTPPollingSource:
    def __init__(
        self,
        url: str,
        interval_s: float = 1.0,
        client: Optional[httpx.AsyncClient] = None,
    ) -> None:
        self.url = url
        self.interval_s = interval_s
        self._client = client

    async def stream(self) -> AsyncGenerator[str, None]:
        own = self._client is None
        client = self._client or httpx.AsyncClient()
        try:
            while True:
                resp = await client.get(self.url)
                text = resp.text.strip()
                if not text:
                    return
                yield text
                await asyncio.sleep(self.interval_s)
        finally:
            if own:
                await client.aclose()
