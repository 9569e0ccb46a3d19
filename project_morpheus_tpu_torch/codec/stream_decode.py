"""Stateful streaming SNAC decode: cached context, 4-frame hops
(port of codec/stream_decode.py, exact mode).

Per-layer activation tails are cached at a commit frontier, so each hop
decodes a static 4-frame window ``[t-3 .. t]``, emits frame ``t-2`` and
commits frame ``t-3``.  The decoder's future receptive cone is shorter
than 3 frames, so committed tails equal a full-prefix decode's activations
and every emitted mid-stream frame equals ``snac_decode(frames[0..t])`` at
that frame's position.  State is batched by lane (engine slot); lanes with
``commit=False`` keep their state, and lanes reset to zeros on admission.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .frames import FRAME_TOKENS, tokens_to_codes
from .snac import phase_banks, phase_combine, rvq_from_codes, snake
from .snac_config import SNACConfig

State = Dict[str, torch.Tensor]

WINDOW_FRAMES = 4   # [t-3 .. t]
EMIT_SLOT = 1       # frame t-2: 2-frame lookahead


def _tail_specs(cfg: SNACConfig):
    """(name, tail_len, channels): every stateful conv site, decode order.
    Tails store the RAW (pre-activation) inputs of each conv site."""
    specs = [("in", 3, cfg.latent)]
    for i, _rate in enumerate(cfg.decoder_rates):
        in_dim = cfg.decoder_dim // (2**i)
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        specs.append((f"b{i}_up", 1, in_dim))
        for j, dil in enumerate((1, 3, 9)):
            specs.append((f"b{i}_res{j}", 3 * dil, out_dim))
    specs.append(("out", 3, cfg.decoder_dim // (2 ** len(cfg.decoder_rates))))
    return specs


def init_stream_state(cfg: SNACConfig, batch: int, device="cuda",
                      dtype=torch.float32) -> State:
    """Zero tails == the stream-head zero padding of a full decode."""
    return {name: torch.zeros((batch, tail, ch), dtype=dtype, device=device)
            for name, tail, ch in _tail_specs(cfg)}


def reset_lanes(state: State, lane_mask: torch.Tensor) -> State:
    """Zero the tails of lanes where ``lane_mask`` is True, in place (a
    masked fill: no host sync)."""
    for v in state.values():
        v.masked_fill_(lane_mask[:, None, None], 0.0)
    return state


def _advance(tail, raw_x, frame: int, commit):
    """Slide the cached tail one committed frame forward."""
    p = tail.shape[1]
    new = torch.cat([tail, raw_x], dim=1)[:, frame:frame + p]
    return torch.where(commit[:, None, None], new, tail)


def _ctx_conv(x, left, w, b, *, dilation: int, depthwise: bool):
    """'Same'-padded conv with the left pad taken from cached context; the
    right side zero-pads like a prefix decode's edge."""
    B, T, C = x.shape
    k = w.shape[0]
    p = (k - 1) * dilation // 2
    xin = torch.cat([left[:, left.shape[1] - p:], x, x.new_zeros((B, p, C))], dim=1)
    y = None
    for kk in range(k):
        sl = xin[:, kk * dilation: kk * dilation + T]
        contrib = sl * w[kk, 0][None, None, :] if depthwise else sl @ w[kk]
        y = contrib if y is None else y + contrib
    return y + b if b is not None else y


def _ctx_conv_transpose(x, left, w_flipped, b, *, stride: int):
    """Streaming phase-decomposed ConvTranspose1d with x[-1] from the cache."""
    B, T, c_in = x.shape
    x_m1 = torch.cat([left, x[:, :-1]], dim=1)
    x_p1 = torch.cat([x[:, 1:], x.new_zeros((B, 1, c_in))], dim=1)
    return phase_combine(x, x_m1, x_p1, phase_banks(w_flipped, stride), stride, b)


@torch.no_grad()
def snac_stream_body(
    params,
    window_tokens: torch.Tensor,  # (B, WINDOW_FRAMES * 7) int code entries
    state: State,
    commit: torch.Tensor,          # (B,) bool — lanes advancing their state
    *,
    cfg: SNACConfig,
) -> Tuple[torch.Tensor, State]:
    """One streaming hop for a batch of lanes: int16 PCM of the whole
    window ``(B, WINDOW_FRAMES * frame_samples)`` and the next state
    (a new dict; lanes with ``commit=False`` keep their tails)."""
    ns: State = {}
    dec = params["decoder"]
    z = rvq_from_codes(params, tokens_to_codes(window_tokens), cfg)
    frame = z.shape[1] // WINDOW_FRAMES
    if cfg.depthwise:
        x = _ctx_conv(z, state["in"], dec["in_dw_w"], dec["in_dw_b"], dilation=1, depthwise=True)
        x = x @ dec["in_pw_w"][0] + dec["in_pw_b"]
    else:
        x = _ctx_conv(z, state["in"], dec["in_w"], dec["in_b"], dilation=1, depthwise=False)
    ns["in"] = _advance(state["in"], z, frame, commit)
    for i, rate in enumerate(cfg.decoder_rates):
        blk = dec["blocks"][i]
        depthwise = cfg.depthwise
        raw = x
        ns[f"b{i}_up"] = _advance(state[f"b{i}_up"], raw, frame, commit)
        x = _ctx_conv_transpose(snake(raw, blk["alpha_up"]),
                                snake(state[f"b{i}_up"], blk["alpha_up"]),
                                blk["up_w"], blk["up_b"], stride=rate)
        frame *= rate
        for j, dil in enumerate((1, 3, 9)):
            p = blk[f"res{j + 1}"]
            key = f"b{i}_res{j}"
            raw = x
            ns[key] = _advance(state[key], raw, frame, commit)
            y = _ctx_conv(snake(raw, p["alpha1"]), snake(state[key], p["alpha1"]),
                          p["w1"], p["b1"], dilation=dil, depthwise=depthwise)
            y = snake(y, p["alpha2"])
            x = raw + (y @ p["w2"][0] + p["b2"])
    raw = x
    ns["out"] = _advance(state["out"], raw, frame, commit)
    x = _ctx_conv(snake(raw, dec["alpha_out"]), snake(state["out"], dec["alpha_out"]),
                  dec["out_w"], dec["out_b"], dilation=1, depthwise=False)
    x = torch.tanh(x)[..., 0]
    # float -> int16 truncates toward zero, as XLA's convert does
    return (x * 32767.0).to(torch.int16), ns


# the JAX package's name for its jitted hop (which donates ``state``: the
# body already returns a new dict)
snac_stream_step = snac_stream_body


# ------------------------------------------------------------- host planner


@dataclasses.dataclass(frozen=True)
class Hop:
    """One lane's work for a stream hop: the window, whether it commits,
    and the ``(frame_index, window_slot)`` pairs to route out."""

    window: np.ndarray  # (WINDOW_FRAMES * 7,) int32 codebook entries
    commit: bool
    emits: Tuple[Tuple[int, int], ...]


class StreamPlanner:
    """Host-side hop scheduler for one stream (one engine lane).

    Frame 0 is emitted from a head hop ``[f0 f0 f0 f0]`` (no commit); frame
    t-2 from each steady hop ``[t-3 .. t]`` (commit); flush drains every
    unemitted tail frame from one last no-commit hop, a trailing partial
    frame padded by repeating its last code."""

    def __init__(self) -> None:
        self.frames: List[np.ndarray] = []
        self.partial: List[int] = []
        self.emitted = 0  # frames [0, emitted) already routed out

    def push(self, code: int) -> List[Hop]:
        """Feed one codebook entry; returns hops to run (0 or 1)."""
        self.partial.append(int(code))
        if len(self.partial) < FRAME_TOKENS:
            return []
        self.frames.append(np.asarray(self.partial, np.int32))
        self.partial = []
        return self._on_frame()

    def _on_frame(self) -> List[Hop]:
        t = len(self.frames) - 1
        if t == 0:
            self.emitted = 1
            return [Hop(np.tile(self.frames[0], WINDOW_FRAMES), False, ((0, 0),))]
        if t < WINDOW_FRAMES - 1:
            return []  # frames 1, 2 wait for their 2-frame lookahead
        window = np.concatenate(self.frames[t - 3: t + 1])
        self.emitted = t - 1
        return [Hop(window, True, ((t - 2, EMIT_SLOT),))]

    def flush(self) -> List[Hop]:
        """End of stream: one hop draining all unemitted tail frames."""
        if self.partial:
            pad = self.partial[-1]
            self.partial += [pad] * (FRAME_TOKENS - len(self.partial))
            self.frames.append(np.asarray(self.partial, np.int32))
            self.partial = []
        T = len(self.frames) - 1
        if T < 0 or self.emitted > T:
            return []
        lo = max(T - (WINDOW_FRAMES - 1), 0)
        win = self.frames[lo: T + 1]
        win = win + [self.frames[-1]] * (WINDOW_FRAMES - len(win))
        emits = tuple((f, f - lo) for f in range(max(self.emitted, lo), T + 1))
        assert self.emitted >= lo, "tail frames fell outside the flush window"
        self.emitted = T + 1
        return [Hop(np.concatenate(win), False, emits)]


class ExactStreamDecoder:
    """Single-stream facade over the exact stateful decoder (one lane):
    ``push_tokens``/``flush``/``reset``, hops through ``snac_stream_body``,
    the same function the engine's audio mode batches across slots."""

    def __init__(self, params, cfg: Optional[SNACConfig] = None, device=None) -> None:
        self.params = params
        self.cfg = cfg or SNACConfig.snac_24khz()
        self.device = device if device is not None else params["decoder"]["out_w"].device
        self.reset()

    def reset(self) -> None:
        self.planner = StreamPlanner()
        self.state = init_stream_state(self.cfg, 1, self.device)

    def _run_hops(self, hops: List[Hop]) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        fs = self.cfg.frame_samples
        for h in hops:
            pcm, self.state = snac_stream_body(
                self.params,
                torch.as_tensor(h.window[None], device=self.device),
                self.state,
                torch.tensor([h.commit], device=self.device),
                cfg=self.cfg,
            )
            pcm_np = pcm.cpu().numpy()
            for _frame_idx, ws in h.emits:
                out.append(pcm_np[0, ws * fs: (ws + 1) * fs])
        return out

    def push_tokens(self, codes: Sequence[int]) -> List[np.ndarray]:
        hops: List[Hop] = []
        for c in codes:
            hops.extend(self.planner.push(int(c)))
        return self._run_hops(hops)

    def flush(self) -> List[np.ndarray]:
        return self._run_hops(self.planner.flush())


def make_stream_decoder(params, cfg: Optional[SNACConfig] = None, mode: str = "exact"):
    """Per-stream decoder by mode.

    - ``"exact"`` / ``"native"`` (default): ExactStreamDecoder, identical
      PCM to the engine's batched audio path for the same token trace.
    - ``"windowed"``: the windowed recompute decoder (A/B comparisons).
    - ``"parity"``: the reference-quirk-exact windowed decoder (golden
      traces vs speechpipe.py:191-293).
    """
    if mode in ("exact", "native"):
        return ExactStreamDecoder(params, cfg)
    from .streaming import StreamingSnacDecoder

    if mode == "windowed":
        return StreamingSnacDecoder(params, cfg, mode="native")
    if mode == "parity":
        return StreamingSnacDecoder(params, cfg, mode="parity")
    raise ValueError(f"unknown decoder mode {mode!r}")
