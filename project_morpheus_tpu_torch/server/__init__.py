"""HTTP API server (aiohttp): speech synthesis, voices, stats (port of
server/__init__.py), and its Python client."""

from .app import create_app, start_server
from .client import Client

__all__ = ["create_app", "start_server", "Client"]
