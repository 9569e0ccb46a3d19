"""The roofline and MFU counts against hand-computed values, tiny sizes:
the llama family's, and ``lib/counts.py`` reaching them through the
family that ``run.d`` names."""
import shutil

import pytest

import benchmark.families
from benchmark.families.llama import counts
from benchmark.lib import counts as run_counts
from benchmark.tests.conftest import ROOT

# D 8, F 16, L 2, H 4, KV 2, HD 2, Vp 256
D = dict(D=8, F=16, L=2, H=4, KV=2, HD=2, Vp=256, V=250, tied=False)


def test_layer_mats():
    assert counts.layer_mats(D) == [(8, 16), (8, 8), (8, 32), (16, 8)]
    # 2 layers x (128 + 64 + 256 + 128) + head 8 x 256
    assert counts.matmul_params(D) == 2 * 576 + 2048


def test_decode_step_gemv_bytes():
    rows = 3
    per_layer = sum(k * n + 4 * n + rows * 2 * (k + n)
                    for k, n in [(8, 16), (8, 8), (8, 32), (16, 8)])
    head = 8 * 256 + 4 * 256 + rows * (2 * 8 + 2 * 256)
    assert counts.decode_step_gemv_bytes(D, rows) == 2 * per_layer + head
    tied = dict(D, tied=True)
    assert counts.head_gemv_bytes(tied, 1) == 8 * 256 + 4 * 256 + (2 * 8 + 4 * 256)


def test_w8a8_bound_takes_the_larger_term():
    rows = 4
    t = 0.0
    for k, n in [(8, 16), (8, 8), (8, 32), (16, 8)]:
        t += max(2 * rows * k * n / 1.979e15, (k * n + 4 * n + rows * (k + 4 + 2 * n)) / 3.35e12)
    assert counts.w8a8_round_bound_s(D, rows) == pytest.approx(2 * t)
    big = dict(D=4096, F=14336, L=1, H=32, KV=8, HD=128, Vp=256, tied=False)
    ops = 2 * 4096 * sum(k * n for k, n in counts.layer_mats(big))
    assert counts.w8a8_round_bound_s(big, 4096) == pytest.approx(ops / 1.979e15)


def test_decode_and_prefill_flops():
    keys = 10
    flops = 2 * counts.matmul_params(D) + 4 * keys * 4 * 2 * 2
    assert counts.decode_token_s_at_peak(D, keys) == pytest.approx(flops / 989e12)
    # 3 tokens from offset 5: positions 5, 6, 7 attend 6, 7, 8 keys
    proj = 2 * 3 * 2 * 576
    attn = 4 * (6 + 7 + 8) * 4 * 2 * 2
    head = 2 * 8 * 256
    assert counts.prefill_tokens_s_at_peak(D, 5, 3) == pytest.approx(
        proj / 1.979e15 + (attn + head) / 989e12)
    assert counts.prefill_tokens_s_at_peak(D, 5, 0) == 0.0


def test_counts_follow_the_run_s_family(tmp_path, monkeypatch):
    run_d = dict(D, family="llama")
    assert run_counts.decode_step_gemv_bytes(run_d, 3) == counts.decode_step_gemv_bytes(D, 3)
    assert run_counts.head_gemv_bytes(run_d, 2) == counts.head_gemv_bytes(D, 2)
    assert run_counts.w8a8_round_bound_s(run_d, 4) == counts.w8a8_round_bound_s(D, 4)
    assert run_counts.decode_token_s_at_peak(run_d, 9) == counts.decode_token_s_at_peak(D, 9)
    assert run_counts.prefill_tokens_s_at_peak(run_d, 5, 3) == \
        counts.prefill_tokens_s_at_peak(D, 5, 3)
    # a family with no counts of its own reads none of llama's
    shutil.copytree(ROOT / "benchmark" / "families" / "llama", tmp_path / "nocounts",
                    ignore=shutil.ignore_patterns("__pycache__", "counts.py"))
    monkeypatch.setattr(benchmark.families, "__path__",
                        [*benchmark.families.__path__, str(tmp_path)])
    with pytest.raises(KeyError, match="nocounts/counts.py"):
        run_counts.decode_step_gemv_bytes(dict(D, family="nocounts"), 3)
    with pytest.raises(KeyError):
        run_counts.decode_token_s_at_peak(D, 9)
