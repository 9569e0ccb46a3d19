"""HTTP API server (aiohttp): speech synthesis, voices, stats."""
