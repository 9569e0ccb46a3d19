"""The inputs both sides are handed: random weights made from the seed.

Weights are drawn on the device with one seeded ``torch.Generator`` for
each tree, one call for each stacked leaf, in the dtype they are served in
(bf16 for the decoder, fp32 for the codec).  The program quantizes and
fuses them itself; the plain reference makes the same tensors again from
the same seed after the window and works out the int8 weights on its
own.  The layouts are the program's interface: a codec conv ``(k,
in/groups, out)``, a transposed conv time-flipped ``(k, in, out)``.  This
module holds what every configuration shares, the generator and the SNAC
codec; a decoder's tree is its family's (``families/<family>/weights.py``).
Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

_SNAC_STREAM = 0x5EED_5AC


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2**63)


def _snac_shapes(c: Dict):
    """(name, shape, bound) of every codec leaf, in draw order; bound 0
    marks a Snake alpha (drawn in [0.5, 1.5])."""
    lat, d = c["latent"], c["decoder_dim"]
    out = []
    for i, _ in enumerate(c["vq_strides"]):
        out += [(f"q{i}.out_w", (1, c["codebook_dim"], lat), c["codebook_dim"] ** -0.5),
                (f"q{i}.out_b", (lat,), c["codebook_dim"] ** -0.5)]
    out += [("in_dw_w", (7, 1, lat), 7 ** -0.5), ("in_dw_b", (lat,), 7 ** -0.5),
            ("in_pw_w", (1, lat, d), lat ** -0.5), ("in_pw_b", (d,), lat ** -0.5)]
    for i, rate in enumerate(c["decoder_rates"]):
        cin, cout = d // 2 ** i, d // 2 ** (i + 1)
        k = 2 * rate
        out += [(f"b{i}.alpha_up", (cin,), 0),
                (f"b{i}.up_w", (k, cin, cout), (cin * k) ** -0.5),
                (f"b{i}.up_b", (cout,), (cin * k) ** -0.5)]
        for j in (1, 2, 3):
            out += [(f"b{i}.res{j}.alpha1", (cout,), 0),
                    (f"b{i}.res{j}.w1", (7, 1, cout), 7 ** -0.5),
                    (f"b{i}.res{j}.b1", (cout,), 7 ** -0.5),
                    (f"b{i}.res{j}.alpha2", (cout,), 0),
                    (f"b{i}.res{j}.w2", (1, cout, cout), cout ** -0.5),
                    (f"b{i}.res{j}.b2", (cout,), cout ** -0.5)]
    last = d // 2 ** len(c["decoder_rates"])
    out += [("alpha_out", (last,), 0), ("out_w", (7, last, 1), (7 * last) ** -0.5),
            ("out_b", (1,), (7 * last) ** -0.5)]
    return out


@torch.no_grad()
def snac_weights(codec: Dict, seed: int, device) -> Dict:
    """The SNAC decoder's weights in the program's tree: uniform in
    [-b, b] with b = fan_in ** -0.5 (PyTorch's conv default bound, as the
    released checkpoint's init), codebooks N(0, 1); two generator calls."""
    g = generator(seed, _SNAC_STREAM, device)
    shapes = _snac_shapes(codec)
    flat = torch.rand((sum(math.prod(s) for _, s, _ in shapes),), generator=g, device=device,
                      dtype=torch.float32)
    books = torch.randn((len(codec["vq_strides"]), codec["codebook_size"], codec["codebook_dim"]),
                        generator=g, device=device, dtype=torch.float32)
    leaves, pos = {}, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        u = flat[pos:pos + n].reshape(shape)
        pos += n
        leaves[name] = u + 0.5 if bound == 0 else (u * 2 - 1) * bound
    quant = [{"codebook": books[i], "out_w": leaves[f"q{i}.out_w"], "out_b": leaves[f"q{i}.out_b"]}
             for i in range(len(codec["vq_strides"]))]
    blocks = []
    for i, _ in enumerate(codec["decoder_rates"]):
        blk = {"alpha_up": leaves[f"b{i}.alpha_up"], "up_w": leaves[f"b{i}.up_w"],
               "up_b": leaves[f"b{i}.up_b"]}
        for j in (1, 2, 3):
            blk[f"res{j}"] = {k: leaves[f"b{i}.res{j}.{k}"]
                              for k in ("alpha1", "w1", "b1", "alpha2", "w2", "b2")}
        blocks.append(blk)
    dec = {k: leaves[k] for k in ("in_dw_w", "in_dw_b", "in_pw_w", "in_pw_b", "alpha_out",
                                  "out_w", "out_b")}
    dec["blocks"] = blocks
    return {"quantizer": quant, "decoder": dec, "encoder": None}
