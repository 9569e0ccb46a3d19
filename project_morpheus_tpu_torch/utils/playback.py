"""Optional local audio playback (host-side peripheral; port of
utils/playback.py).

Reference parity: Morpheus_Client/tts_engine/inference.py:7-12,226-242 —
``sounddevice``/PortAudio playback of PCM16 hops, degraded to a no-op when
the audio stack is absent (the reference stubs ``sd`` the same way).  This
stays host-side and optional by design (SURVEY §2.3): serving delivers PCM
over HTTP/WS; local playback only matters for the CLI/demo path.

``LocalPlayback`` adds what a pull-based console player actually needs on
top of the reference's fire-and-forget ``sd.play``: sequential hop
playback without truncation (the reference's per-chunk ``play``+``wait``
cannot overlap decode with output), a byte counter for progress display,
and an explicit ``available`` flag so callers can branch instead of
silently dropping audio.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_RATE = 24_000

try:  # optional runtime dependency; absent in server deployments
    import sounddevice as _sd
except Exception:  # pragma: no cover - PortAudio missing
    _sd = None


def playback_available() -> bool:
    """True when a local audio output device stack is importable."""
    return _sd is not None


def stream_audio(audio_buffer: Optional[bytes],
                 sample_rate: int = SAMPLE_RATE) -> bool:
    """Play one PCM16 buffer on the default output device.

    Exact behavioural mirror of the reference ``stream_audio``
    (inference.py:226-242): empty input is ignored, playback errors are
    logged rather than raised, and the call blocks until the buffer has
    played.  Returns True when audio was actually played.
    """
    if not audio_buffer:
        return False
    if _sd is None:
        logger.debug("local playback unavailable (sounddevice not installed)")
        return False
    try:
        audio = np.frombuffer(audio_buffer, dtype=np.int16)
        _sd.play(audio.astype(np.float32) / 32767.0, sample_rate)
        _sd.wait()
        return True
    except Exception as exc:  # pragma: no cover - device errors
        logger.warning("audio playback error: %s", exc)
        return False


class LocalPlayback:
    """Sequential hop player for streaming consumers.

    Usage::

        player = LocalPlayback()
        async for pcm in req.pcm_chunks():
            player.play(pcm)
        player.close()

    When no output stack is present every call is a cheap no-op and
    ``bytes_played`` still counts, so demo scripts behave identically in
    headless environments.
    """

    def __init__(self, sample_rate: int = SAMPLE_RATE) -> None:
        self.sample_rate = sample_rate
        self.bytes_played = 0
        self._stream = None
        if _sd is not None:
            try:
                self._stream = _sd.OutputStream(
                    samplerate=sample_rate, channels=1, dtype="int16"
                )
                self._stream.start()
            except Exception as exc:  # pragma: no cover - device errors
                logger.warning("could not open audio output: %s", exc)
                self._stream = None

    @property
    def available(self) -> bool:
        return self._stream is not None

    def play(self, pcm: Optional[bytes]) -> None:
        """Queue one PCM16 hop; no-op (but counted) without a device."""
        if not pcm:
            return
        self.bytes_played += len(pcm)
        if self._stream is not None:
            try:
                self._stream.write(np.frombuffer(pcm, dtype=np.int16))
            except Exception as exc:  # pragma: no cover - device errors
                logger.warning("audio playback error: %s", exc)

    def close(self) -> None:
        if self._stream is not None:
            try:
                self._stream.stop()
                self._stream.close()
            finally:
                self._stream = None
