"""Plain reference of the SNAC 24 kHz decoder and of the streamed hops.

The decoder as published (hubertsiuzdak/snac): residual codebooks summed
at the fine rate, a depthwise and a pointwise input conv, four blocks of
Snake, a transposed conv and three dilated depthwise residual units, a
last Snake, conv and tanh, with the noise blocks off.  Written with
``torch.nn.functional.conv1d`` / ``conv_transpose1d`` on ``(B, C, T)``,
in fp32 with TF32 off (``tf32=True`` is the control).

The streamed hops (one 2048-sample hop a 7-token frame): frame 0 is the
first frame decoded alone, four times repeated; frame ``f >= 1`` is frame
``f`` of the decode of frames ``[0 .. min(f + 2, T)]`` (two frames of
lookahead, the end of the stream at the last; a stream of fewer than 4
frames is padded to 4 with its last frame, as its one end-of-stream hop
pads its window).  A decode is exact from
``cone`` frames on before its first frame, the decoder's receptive field
(``cone_frames``), so frame ``f`` is taken from the decode of frames
``[f - margin .. f + 2]`` with ``margin`` above it.  Imports nothing of
the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

FRAME_TOKENS = 7


def _snake(x, a):
    a = a[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _conv_w(w):  # (k, in/groups, out) -> (out, in/groups, k)
    return w.permute(2, 1, 0).contiguous()


def cone_frames(codec: Dict) -> float:
    """Frames of context one side of an output sample reaches."""
    fine = 4  # fine codes a frame
    reach = 3 / fine  # the input conv
    rate = fine
    for r in codec["decoder_rates"]:
        reach += 1 / rate  # a transposed conv reads one input step past
        rate *= r
        reach += 3 * (1 + 3 + 9) / rate  # residual units, dilations 1, 3, 9
    return reach + 3 / rate


def frames_to_codes(frames: torch.Tensor):
    """(B, n, 7) code entries -> the three levels (B, n), (B, 2n), (B, 4n)."""
    B, n, _ = frames.shape
    return (frames[..., 0], frames[..., [1, 4]].reshape(B, 2 * n),
            frames[..., [2, 3, 5, 6]].reshape(B, 4 * n))


@torch.no_grad()
def decode(params: Dict, codec: Dict, frames: torch.Tensor) -> torch.Tensor:
    """(B, n, 7) code entries -> int16 PCM (B, n * frame samples)."""
    z = None
    for lvl, (codes, stride) in enumerate(zip(frames_to_codes(frames.long()),
                                              codec["vq_strides"])):
        q = params["quantizer"][lvl]
        zl = q["codebook"][codes] @ q["out_w"][0] + q["out_b"]
        zl = zl.repeat_interleave(stride, dim=1)
        z = zl if z is None else z + zl
    dec = params["decoder"]
    x = z.transpose(1, 2)
    x = F.conv1d(x, _conv_w(dec["in_dw_w"]), dec["in_dw_b"], padding=3, groups=x.shape[1])
    x = F.conv1d(x, _conv_w(dec["in_pw_w"]), dec["in_pw_b"])
    for blk, rate in zip(dec["blocks"], codec["decoder_rates"]):
        x = _snake(x, blk["alpha_up"])
        w = torch.flip(blk["up_w"], dims=[0]).permute(1, 2, 0).contiguous()  # (in, out, k)
        x = F.conv_transpose1d(x, w, blk["up_b"], stride=rate, padding=math.ceil(rate / 2))
        for j, dil in enumerate((1, 3, 9)):
            p = blk[f"res{j + 1}"]
            y = _snake(x, p["alpha1"])
            y = F.conv1d(y, _conv_w(p["w1"]), p["b1"], padding=3 * dil, dilation=dil,
                         groups=x.shape[1])
            y = _snake(y, p["alpha2"])
            x = x + F.conv1d(y, _conv_w(p["w2"]), p["b2"])
    x = _snake(x, dec["alpha_out"])
    x = F.conv1d(x, _conv_w(dec["out_w"]), dec["out_b"], padding=3)
    return (torch.tanh(x[:, 0]) * 32767.0).to(torch.int16)


@torch.no_grad()
def stream_hops(params: Dict, codec: Dict, codes: np.ndarray) -> List[np.ndarray]:
    """The hops a stream of ``codes`` (T * 7 code entries) plays, one a
    frame, as int16 arrays."""
    dev = params["decoder"]["out_w"].device
    fr = torch.as_tensor(np.asarray(codes).reshape(-1, FRAME_TOKENS), device=dev)
    T = fr.shape[0]
    fs = 4 * math.prod(codec["decoder_rates"])
    if T < 4:  # the end-of-stream hop pads a short stream with its last frame
        fr = torch.cat([fr, fr[-1:].repeat(4 - T, 1)])
    margin = math.ceil(cone_frames(codec)) + 1
    hops = [decode(params, codec, fr[:1].repeat(4, 1)[None])[0, :fs]]
    # frames with a whole window [f - margin, f + 2] share one batched decode
    n = fr.shape[0]
    whole = [f for f in range(1, T) if f - margin >= 0 and f + 2 <= n - 1]
    rest = [f for f in range(1, T) if f not in set(whole)]
    out = {}
    if whole:
        wins = torch.stack([fr[f - margin: f + 3] for f in whole])
        pcm = decode(params, codec, wins)
        for i, f in enumerate(whole):
            out[f] = pcm[i, margin * fs:(margin + 1) * fs]
    for f in rest:
        lo, hi = max(0, f - margin), min(f + 2, n - 1)
        out[f] = decode(params, codec, fr[lo:hi + 1][None])[0, (f - lo) * fs:(f - lo + 1) * fs]
    hops += [out[f] for f in range(1, min(T, fr.shape[0]))]
    return [h.cpu().numpy() for h in hops]
