"""Pull-based PCM orchestration (reference L4, Morpheus_Client/orchestrator/).

Playback is the clock: the orchestrator pulls chunks from a TTSAdapter at
the granularity chosen by an adaptive chunk ladder, tracks playback buffer
depth, honours barge-in at chunk boundaries, and records a structured
timeline for replay.  Pure host-side Python — the device work happens
behind the adapter protocol.
"""

from .adapter import AudioChunk, TTSAdapter
from .buffer import PlaybackBuffer
from .chunk_ladder import ChunkLadder, DEFAULT_LADDER
from .ring_buffer import RingBuffer
from .stitcher import stitch_chunks
from .core import Orchestrator

__all__ = [
    "AudioChunk",
    "TTSAdapter",
    "PlaybackBuffer",
    "ChunkLadder",
    "DEFAULT_LADDER",
    "RingBuffer",
    "stitch_chunks",
    "Orchestrator",
]
