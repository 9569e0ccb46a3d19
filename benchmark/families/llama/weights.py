"""The llama family's decoder inputs: its sizes and its random weights,
made from the seed in the program's layout, ``(layers, in, out)`` for a
projection.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.lib.weights import generator

_STREAM = 0x5EED_11A


def dims(conf: Dict) -> Dict:
    """The decoder's sizes from a configuration file."""
    vocab = conf["vocab_size"]
    return dict(D=conf["hidden_size"], F=conf["intermediate_size"],
                L=conf["num_hidden_layers"], H=conf["num_attention_heads"],
                KV=conf["num_key_value_heads"], HD=conf["head_dim"], V=vocab,
                Vp=(vocab + 255) // 256 * 256, tied=bool(conf["tie_word_embeddings"]),
                theta=float(conf["rope_theta"]), eps=float(conf["rms_norm_eps"]))


@torch.no_grad()
def weights(conf: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """``{"embed", "layers": {stacked leaves}, "ln_f"[, "lm_head"]}``.
    Projection scales are ``fan_in ** -0.5``, the embedding's 0.02, and
    the norm scales 1 + 0.1 N(0, 1), so that a norm applied at the wrong
    place shows."""
    d = dims(conf)
    D, F, L, H, KV, HD, Vp = (d[k] for k in ("D", "F", "L", "H", "KV", "HD", "Vp"))
    g = generator(seed, _STREAM, device)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(scale)

    def norm(shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(0.1).add_(1.0)

    params = {
        "embed": normal((Vp, D), 0.02),
        "layers": {
            "ln1": norm((L, D)),
            "wq": normal((L, D, H * HD), D ** -0.5),
            "wk": normal((L, D, KV * HD), D ** -0.5),
            "wv": normal((L, D, KV * HD), D ** -0.5),
            "wo": normal((L, H * HD, D), (H * HD) ** -0.5),
            "ln2": norm((L, D)),
            "wg": normal((L, D, F), D ** -0.5),
            "wu": normal((L, D, F), D ** -0.5),
            "wd": normal((L, F, D), F ** -0.5),
        },
        "ln_f": norm((D,)),
    }
    if not d["tied"]:
        params["lm_head"] = normal((D, Vp), D ** -0.5)
    return params
