"""Fixed-latency windowed SNAC decode (port of codec/streaming.py).

Reference semantics (Morpheus_Client/tts_engine/speechpipe.py:191-293):
tokens arrive one at a time; the first audio is attempted after 7 tokens
(1 frame), then one hop per 7 tokens using a sliding window of the last 49
tokens (ideal) or 28 (min), always emitting waveform slice ``[2048:4096]``
of the decoded window: one 2048-sample frame (85.3 ms @ 24 kHz) per hop.

Two modes:

- ``mode="parity"`` reproduces the reference exactly, including its quirks:
  the 7-token first window decodes to 2048 samples so the ``[2048:4096]``
  slice is *empty*, and when the buffer first reaches 49 tokens the
  emitted window position rewinds by two frames (duplicated audio).  Kept
  for golden-trace compatibility against the reference pipeline.
- ``mode="native"`` (default): one static 7-frame window, edge-replicated
  at stream head and tail; each hop emits the next unemitted frame with
  ``lookahead`` frames of real right-context, the first one right after
  7 tokens.

The decode window is recomputed per hop (like the reference).  The
serving engine uses ``stream_decode`` instead (cached conv tails, exact
prefix-decode output); this module is the A/B and golden-trace decoder
(``make_stream_decoder(mode="windowed" | "parity")``).

Many native streams decode together: ``plan_push`` / ``plan_flush`` return
the windows that ``push_tokens`` / ``flush`` would decode, and
:func:`decode_windows_batched` decodes a stack of them in one call.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .frames import FRAME_TOKENS, tokens_to_codes
from .snac import snac_decode
from .snac_config import SNACConfig


HOP_SAMPLES = 2048  # samples emitted per 7-token hop (snac_24khz)


@torch.no_grad()
def decode_windows_batched(params, windows, *, cfg: SNACConfig, emit_lo: int,
                           emit_hi: int) -> torch.Tensor:
    """Decode many streams' windows in one call: ``windows`` ``(B, n_frames
    * 7)`` integer codebook entries (a tensor or an array) -> int16 PCM
    ``(B, emit_hi - emit_lo)`` on the params' device, scaled by 32767 and
    truncated as the reference does.  One ``tokens_to_codes`` and one
    ``snac_decode`` over the whole batch."""
    dev = params["decoder"]["out_w"].device
    if not isinstance(windows, torch.Tensor):
        windows = torch.as_tensor(np.asarray(windows))
    audio = snac_decode(params, tokens_to_codes(windows.to(dev)), cfg)
    return (audio[:, emit_lo:emit_hi] * 32767.0).to(torch.int16)


def _decode_window_slice(params, tokens: np.ndarray, cfg: SNACConfig, emit_lo: int,
                         emit_hi: int) -> np.ndarray:
    """Decode one window of codebook entries; int16 PCM of ``[emit_lo,
    emit_hi)``."""
    pcm = decode_windows_batched(params, tokens[None], cfg=cfg, emit_lo=emit_lo, emit_hi=emit_hi)
    return pcm[0].cpu().numpy()


class StreamingSnacDecoder:
    """Push audio codes in, get fixed-size PCM16 hops out."""

    def __init__(self, params, cfg: Optional[SNACConfig] = None, *, mode: str = "native",
                 lookahead_frames: int = 2, window_frames: int = 7) -> None:
        if mode not in ("native", "parity"):
            raise ValueError(f"mode {mode!r}: 'native' or 'parity'")
        self.params = params
        self.cfg = cfg or SNACConfig.snac_24khz()
        self.mode = mode
        self.lookahead = lookahead_frames
        self.window_frames = window_frames
        self.hop = self.cfg.frame_samples
        self.reset()

    # ------------------------------------------------------------------ api

    def reset(self) -> None:
        self._buffer: List[int] = []  # flat stream of codebook entries
        self._emitted_frames = 0
        self._first_done = False

    @property
    def frames_buffered(self) -> int:
        return len(self._buffer) // FRAME_TOKENS

    def push_tokens(self, codes: Sequence[int]) -> List[np.ndarray]:
        """Feed codebook entries (band-unshifted ids); returns PCM16 hops."""
        if self.mode == "native":
            return [self._emit_native(w) for w in self.plan_push(codes)]
        out: List[np.ndarray] = []
        for code in codes:
            self._buffer.append(int(code))
            if len(self._buffer) % FRAME_TOKENS == 0:
                hop = self._parity_hop()
                if hop is not None:
                    out.append(hop)
        return out

    def flush(self) -> List[np.ndarray]:
        """End of stream: drain remaining frames (reference :262-293)."""
        if self.mode == "native":
            return [self._emit_native(w) for w in self.plan_flush()]
        hop = self._parity_flush()
        return [] if hop is None else [hop]

    # --------------------------------------------------- batched planning

    def plan_push(self, codes: Sequence[int]) -> List[np.ndarray]:
        """Like :meth:`push_tokens`, but return the 7-frame decode windows
        instead of PCM (native mode only), for the caller to decode many
        streams' windows in one :func:`decode_windows_batched` call with
        ``emit_lo=4 * hop, emit_hi=5 * hop``."""
        self._require_native("plan_push")
        windows: List[np.ndarray] = []
        for code in codes:
            self._buffer.append(int(code))
            if len(self._buffer) % FRAME_TOKENS == 0:
                k = self.frames_buffered
                e = self._emitted_frames
                if (e == 0 and k >= 1) or (k >= e + 1 + self.lookahead):
                    windows.append(self._window_for(e, k))
                    self._emitted_frames += 1
        return windows

    def plan_flush(self) -> List[np.ndarray]:
        """The end-of-stream windows (native mode only): pad the trailing
        partial frame by repeating the last code, then one window for every
        frame not yet emitted, with replicate right-context."""
        self._require_native("plan_flush")
        if self._buffer and len(self._buffer) % FRAME_TOKENS != 0:
            pad = FRAME_TOKENS - len(self._buffer) % FRAME_TOKENS
            self._buffer.extend([self._buffer[-1]] * pad)
        k = self.frames_buffered
        windows = []
        while self._emitted_frames < k:
            windows.append(self._window_for(self._emitted_frames, k))
            self._emitted_frames += 1
        return windows

    # ------------------------------------------------------------- native

    def _require_native(self, what: str) -> None:
        if self.mode != "native":
            raise ValueError(f"{what} plans native-mode windows; this decoder is {self.mode!r}")

    def _window_for(self, e: int, k: int) -> np.ndarray:
        """Static 7-frame window [e-4 .. e+2] (edge-replicated) for frame e,
        which sits at slot 4 -> samples [4*hop : 5*hop]."""
        frames = np.asarray(self._buffer[: k * FRAME_TOKENS], np.int32).reshape(k, FRAME_TOKENS)
        idx = np.clip(np.arange(e - 4, e + 3), 0, k - 1)
        return frames[idx].reshape(-1)

    def _emit_native(self, window: np.ndarray) -> np.ndarray:
        return _decode_window_slice(self.params, window, self.cfg, 4 * self.hop, 5 * self.hop)

    # -------------------------------------------------------- parity mode

    def _parity_decode(self, tokens: Sequence[int]) -> Optional[np.ndarray]:
        """convert_to_audio equivalent: decode, slice [2048:4096]."""
        n = len(tokens) // FRAME_TOKENS
        if n < 1:
            return None
        arr = np.asarray(tokens[: n * FRAME_TOKENS], dtype=np.int32)
        if np.any(arr < 0) or np.any(arr > self.cfg.codebook_size):
            return None
        total = n * self.cfg.frame_samples
        lo, hi = min(2048, total), min(4096, total)
        if hi <= lo:
            return np.zeros((0,), dtype=np.int16)  # the empty first chunk
        return _decode_window_slice(self.params, arr, self.cfg, lo, hi)

    def _parity_hop(self) -> Optional[np.ndarray]:
        count = len(self._buffer)
        if not self._first_done:
            if count >= 7:
                self._first_done = True
                return self._parity_decode(self._buffer[-7:])
            return None
        if count >= 49:
            return self._parity_decode(self._buffer[-49:])
        if count >= 28:
            return self._parity_decode(self._buffer[-28:])
        return None

    def _parity_flush(self) -> Optional[np.ndarray]:
        buf = self._buffer
        if len(buf) >= 49:
            return self._parity_decode(buf[-49:])
        if len(buf) >= 28:
            return self._parity_decode(buf[-28:])
        if len(buf) >= 7:
            return self._parity_decode(buf + [buf[-1]] * (28 - len(buf)))
        return None
