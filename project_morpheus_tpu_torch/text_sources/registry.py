"""Registry of text sources with capability descriptors
(reference text_sources/registry.py:16-47)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List


@dataclass
class _SourceSpec:
    constructor: Callable[..., Any]
    describe: Callable[[], Dict[str, Any]]


class SourceRegistry:
    def __init__(self) -> None:
        self._specs: Dict[str, _SourceSpec] = {}

    def register(
        self,
        name: str,
        constructor: Callable[..., Any],
        describe: Callable[[], Dict[str, Any]],
    ) -> None:
        self._specs[name] = _SourceSpec(constructor, describe)

    def names(self) -> List[str]:
        return list(self._specs)

    def available(self) -> Dict[str, Dict[str, Any]]:
        return {name: spec.describe() for name, spec in self._specs.items()}

    def create(self, name: str, **kwargs: Any):
        return self._specs[name].constructor(**kwargs)


registry = SourceRegistry()


def _register_bundled() -> None:
    from .cli_pipe import CLIPipeSource
    from .http_poll import HTTPPollingSource
    from .websocket import WebSocketSource

    registry.register(
        "websocket",
        WebSocketSource,
        lambda: {"name": "websocket", "push": True, "config": ["uri"]},
    )
    registry.register(
        "http_poll",
        HTTPPollingSource,
        lambda: {
            "name": "http_poll",
            "push": False,
            "config": ["url", "interval_s"],
        },
    )
    registry.register(
        "cli_pipe",
        CLIPipeSource,
        lambda: {"name": "cli_pipe", "push": True, "config": []},
    )


_register_bundled()
