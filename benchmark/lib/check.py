"""How ``correct`` is decided: the timed path's own outputs against the
plain reference, once the window has closed.

- Served tokens: a sample, drawn from the seed, of the greedy requests
  that finished, the longest among them, until it holds
  ``check.greedy_tokens`` served tokens.  The reference runs once over
  each prompt and its served tokens; ``logit_gap`` is the widest gap by
  which a served token's score (the reference's logit, penalised and
  band-masked as the sampler ranks it) lies below the best score there.
- PCM: a sample of finished requests (the longest, then random ones);
  ``pcm_lsb`` is the largest difference, in int16 steps, between a hop
  the client received and the reference's decode of the request's own
  served codes.
- ``unfinished`` and ``malformed`` count requests that never completed by
  the drain deadline and finished ones whose PCM or token count is wrong.

The reference is the configuration's decoder family's
(``families/<family>/reference.py``) and the SNAC decoder; it makes the
weights again from the seed and takes nothing the program made.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..reference import scoring
from ..reference import snac as ref_snac
from . import spec
from .traffic import AUDIO_BASE, CODEBOOK, FRAME_TOKENS
from .weights import snac_weights


def codes_of(tokens: List[int]) -> np.ndarray:
    t = np.asarray(tokens, np.int64)
    return t - AUDIO_BASE - (np.arange(t.size) % FRAME_TOKENS) * CODEBOOK


def samples(records: List[Dict], seed: int, conf_check: Dict):
    """(greedy sample, PCM sample) of the finished requests."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0xC4EC])
    done = [r for r in records if not r["failed"]]
    greedy = sorted((r for r in done if r["item"].greedy), key=lambda r: -len(r["tokens"]))
    picked, n = [], 0
    if greedy:
        rest = [greedy[i] for i in rng.permutation(len(greedy) - 1) + 1]
        for r in [greedy[0]] + rest:
            if n >= conf_check["greedy_tokens"]:
                break
            picked.append(r)
            n += len(r["tokens"])
    by_len = sorted(done, key=lambda r: -len(r["tokens"]))
    pcm = by_len[:1] + [by_len[1:][i] for i in rng.permutation(max(len(by_len) - 1, 0))]
    return picked, pcm[: conf_check["pcm_requests"]]


def logit_readings(reference, weights, d: Dict, recs: List[Dict], penalty: float,
                   control_bits: int = 0):
    """Per request: the program's widest gap and, with ``control_bits``,
    the gap of the tokens that int-``control_bits`` weights put first.
    ``reference`` is the family's module with ``logits``."""
    seqs = [{"ids": r["item"].prompt + r["tokens"][:-1], "prompt": len(r["item"].prompt),
             "want": list(range(len(r["item"].prompt) - 1,
                                len(r["item"].prompt) + len(r["tokens"]) - 1))} for r in recs]
    with scoring.exact_fp32():
        lg = reference.logits(weights, d, seqs)
        ctl = reference.logits(weights, d, seqs, weight_bits=control_bits) if control_bits \
            else None
    out = []
    for i, r in enumerate(recs):
        sc = scoring.served_scores(lg[i], d, r["item"].prompt, r["tokens"], penalty)
        row = {"tokens": len(r["tokens"]), "gap": scoring.widest_gap(sc, r["tokens"])}
        if ctl is not None:
            cs = scoring.served_scores(ctl[i], d, r["item"].prompt, r["tokens"], penalty)
            row["control_gap"] = scoring.widest_gap(sc, cs.argmax(dim=1).tolist())
        out.append(row)
    return out


def pcm_readings(snac, codec: Dict, recs: List[Dict], control: bool = False):
    """Per request: the largest int16 difference of its received hops from
    the reference's (and, with ``control``, of TF32 hops from fp32 ones)."""
    out = []
    for r in recs:
        codes = codes_of(r["tokens"])
        with scoring.exact_fp32():
            want = ref_snac.stream_hops(snac, codec, codes)
        got = [np.frombuffer(p, np.int16) for p in r["pcm"]]
        row = {"hops": len(got), "lsb": max(int(np.abs(a.astype(np.int64) - b).max())
                                            for a, b in zip(got, want))}
        if control:
            with scoring.exact_fp32(tf32=True):
                tf = ref_snac.stream_hops(snac, codec, codes)
            row["control_lsb"] = max(int(np.abs(a.astype(np.int64) - b).max())
                                     for a, b in zip(tf, want))
        out.append(row)
    return out


def run(conf: Dict, mix: Dict, seed: int, device, records: List[Dict], control: bool = False
        ) -> Dict:
    """The compared numbers with their limits (and, with ``control``, the
    control's readings beside the program's)."""
    import torch

    limits = conf["limits"]
    family = spec.family(conf)
    d = family.weights.dims(conf)
    greedy, pcm = samples(records, seed, mix["check"])
    unfinished = sum(1 for r in records if r["req"] is None or not r["req"].done
                     or r["req"].state.value != "finished")
    malformed = sum(1 for r in records if r["failed"]) - unfinished
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[conf["engine"]["dtype"]]
    detail: Dict = {"greedy_requests": len(greedy),
                    "greedy_tokens": sum(len(r["tokens"]) for r in greedy),
                    "pcm_requests": len(pcm), "pcm_hops": sum(len(r["pcm"]) for r in pcm)}
    gap, lsb = float("inf"), float("inf")
    if greedy:
        w = family.weights.weights(conf, seed, device, dtype)
        rows = logit_readings(family.reference, w, d, greedy,
                              mix["sampling"]["repetition_penalty"],
                              control_bits=4 if control else 0)
        del w
        gap = max(r["gap"] for r in rows)
        detail["logit"] = rows
    if pcm:
        rows = pcm_readings(snac_weights(conf["codec"], seed, device), conf["codec"], pcm,
                            control)
        lsb = max(r["lsb"] for r in rows)
        detail["pcm"] = rows
    checks = {"unfinished": {"value": unfinished, "limit": 0},
              "malformed": {"value": malformed, "limit": 0},
              "logit_gap": {"value": gap, "limit": limits["logit_gap"]},
              "pcm_lsb": {"value": lsb, "limit": limits["pcm_lsb"]}}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok, "checks": checks, "detail": detail}
