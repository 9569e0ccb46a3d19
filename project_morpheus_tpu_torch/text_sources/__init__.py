"""Push-mode text ingestion sources (port of text_sources/; reference L5,
text_sources/).

A ``TextSource`` yields utterance strings; the server consumes a source in
continuous mode, synthesising each yielded line (reference
server.py:99-124).  Bundled sources: websocket client, HTTP poller, CLI
stdin pipe, managed by ``SourceRegistry``.
"""
from __future__ import annotations

from typing import AsyncGenerator, Protocol, runtime_checkable


@runtime_checkable
class TextSource(Protocol):
    """Protocol: an async stream of utterance texts."""

    async def stream(self) -> AsyncGenerator[str, None]: ...


from .registry import SourceRegistry, registry  # noqa: E402
from .websocket import WebSocketSource  # noqa: E402
from .http_poll import HTTPPollingSource  # noqa: E402
from .cli_pipe import CLIPipeSource  # noqa: E402

__all__ = [
    "TextSource",
    "SourceRegistry",
    "registry",
    "WebSocketSource",
    "HTTPPollingSource",
    "CLIPipeSource",
]
