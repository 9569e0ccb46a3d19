"""Time the training attention's candidates on the card at the Orpheus-3B
training shape (B=1, S=8192, H=24, KV=8, HD=128, bf16, keys past 7192
padded):

    python -m project_morpheus_tpu_torch.tools.time_train_attention

- the port's path, ``ops/blockwise_attention.sdpa_attention``, under the
  memory-efficient backend (``SDPA_BACKEND``) and under cuDNN's, both with
  the causal & key-padding mask, and the memory-efficient SDPA call alone
  (its mask and expanded K/V made beforehand; gradients reach Q only);
- for scale, causal attention without the padding mask (exact for the
  real rows of a right-padded batch only) under the memory-efficient,
  flash and cuDNN backends.

Each line: forward ms and forward + backward ms (means of 5 runs after a
warm one, the backward seeded with ones), the largest difference from the
port's path on the real rows, and whether the backward runs under
``torch.use_deterministic_algorithms(True)``.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import subprocess
import time

import torch
import torch.nn.functional as F

B, S, H, KV, HD, REAL = 1, 8192, 24, 8, 128, 7192


def _mean_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def main() -> None:
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ..ops import blockwise_attention as ba

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, S, h, HD, generator=g, device="cuda").to(torch.bfloat16)
               for h in (H, KV, KV))
    mask = torch.ones(B, S, dtype=torch.bool, device="cuda")
    mask[:, REAL:] = False

    def causal(backend):
        def fn(q, k, v, _mask):
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.repeat_interleave(H // KV, 2).transpose(1, 2),
                    v.repeat_interleave(H // KV, 2).transpose(1, 2), is_causal=True)
            return out.transpose(1, 2)
        return fn

    pos = torch.arange(S, device="cuda")
    full_mask = ((pos[:, None] >= pos[None, :])[None] & mask[:, None, :])[:, None]

    def call_alone(q, k, v, _mask):
        """The port's SDPA call by itself: mask and K/V expansion made
        beforehand, no rows without a key to fill."""
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(q.transpose(1, 2), *kv_x, attn_mask=full_mask)
        return out.transpose(1, 2)

    kv_x = [t.repeat_interleave(H // KV, 2).transpose(1, 2) for t in (k, v)]
    cases = [("port: memory-efficient + mask", lambda *a: ba.sdpa_attention(*a)),
             ("its SDPA call alone", call_alone),
             ("cuDNN + mask", lambda *a: ba.sdpa_attention(*a, backend="CUDNN_ATTENTION")),
             ("memory-efficient, causal only", causal(SDPBackend.EFFICIENT_ATTENTION)),
             ("flash, causal only", causal(SDPBackend.FLASH_ATTENTION)),
             ("cuDNN, causal only", causal(SDPBackend.CUDNN_ATTENTION))]
    ref = None
    for name, fn in cases:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def both():
            out = fn(*leaves, mask)
            out.backward(torch.ones_like(out))

        fwd_ms = _mean_ms(lambda: fn(*leaves, mask))
        both_ms = _mean_ms(both)
        out = fn(q, k, v, mask).float()
        ref = out if ref is None else ref
        err = float((out - ref)[:, :REAL].abs().max())
        torch.use_deterministic_algorithms(True)
        try:
            both()
            torch.cuda.synchronize()
            det = "yes"
        except RuntimeError as e:
            det = f"no ({str(e).splitlines()[0][:60]})"
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"{name}: forward {fwd_ms:.3f} ms, forward + backward {both_ms:.3f} ms, max diff "
              f"from the port's path on real rows {err:.3e}, deterministic backward: {det}",
              flush=True)


if __name__ == "__main__":
    main()
