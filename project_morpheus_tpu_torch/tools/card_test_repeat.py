"""Repeat the card-vs-CPU train-step test and watch the numerics flags.

    python -m project_morpheus_tpu_torch.tools.card_test_repeat [RUNS] [FILE_RUNS]

1. ``RUNS`` times in one process (default 20), dense and blockwise
   attention: the two numbers ``tests/test_torch_cuda.py::
   test_train_steps_card_match_cpu`` asserts on, each as a share of its
   limit (the losses' relative difference over 1e-5, the update's
   relative L2 error over 1e-3), and whether the card's params equal the
   run before's bit for bit;
2. that test ``RUNS`` times in one pytest process;
3. the whole of ``tests/test_torch_cuda.py`` ``FILE_RUNS`` times (default
   5), each in a pytest process of its own.

In 2 and 3 this module is a pytest plugin (``-p``) that prints a ``FLAGS
CHANGED`` line for every test after which a global numerics flag (TF32,
cuDNN, deterministic mode, float32 matmul precision, reduced-precision
reductions, the cuBLAS workspace setting) differs from before it.  Run
from the root of the repository; needs a CUDA card.
"""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

TEST = "tests/test_torch_cuda.py"
NAME = "test_train_steps_card_match_cpu"
REPEAT = int(os.environ.get("CARD_TEST_REPEAT", "1"))
PLUGIN = "project_morpheus_tpu_torch.tools.card_test_repeat"  # not __name__: "__main__" when run


def numerics_flags() -> dict:
    return dict(matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_tf32=torch.backends.cudnn.allow_tf32,
                cudnn_deterministic=torch.backends.cudnn.deterministic,
                cudnn_benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.are_deterministic_algorithms_enabled(),
                float32_matmul=torch.get_float32_matmul_precision(),
                bf16_reduced=torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                fp16_reduced=torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
                cublas_workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


# ------------------------------------------------------------ the plugin


def pytest_generate_tests(metafunc):
    if REPEAT > 1 and metafunc.function.__name__ == NAME:
        metafunc.fixturenames.append("repeat_index")
        metafunc.parametrize("repeat_index", range(REPEAT))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    before = numerics_flags()
    yield
    after = numerics_flags()
    if after != before:
        changed = {k: (before[k], after[k]) for k in before if before[k] != after[k]}
        print(f"\nFLAGS CHANGED by {item.nodeid}: {changed}", flush=True)


# ------------------------------------------------------------ the margins


def margins(runs: int) -> None:
    import numpy as np

    from project_morpheus_tpu_torch.model.llama import init_llama_params
    from project_morpheus_tpu_torch.tools import graph_check as gc
    from project_morpheus_tpu_torch.training import pretrain as tp

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = gc.small_config()
    start = init_llama_params(cfg, 3, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.vocab_size, (2, 256)).astype(np.int32)
    mask = np.ones(ids.shape, bool)
    mask[1, 180:] = False
    batch = {"input_ids": ids, "attention_mask": mask, "labels": np.where(mask, ids, -100)}
    tc = tp.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)

    def run(dev, attn):
        params = tp.tree_map(lambda t: t.to(dev, copy=True), start)
        opt = tp.make_optimizer(tc)
        state, step = opt.init(params), tp.make_train_step(cfg, opt, attn_impl=attn)
        return params, [float(step(params, state, batch)[2]) for _ in range(2)]

    for attn in ("dense", "blockwise"):
        pc, lc = run("cpu", attn)
        prev = None
        for i in range(runs):
            pg, lg = run("cuda", attn)
            loss = max(abs(a - b) / (1e-5 * abs(b)) for a, b in zip(lg, lc))
            num = den = 0.0
            for g, c, s in zip(tp.tree_leaves(pg), tp.tree_leaves(pc), tp.tree_leaves(start)):
                want = c.detach().double() - s.double()
                num += float(((g.detach().cpu().double() - s.double() - want) ** 2).sum())
                den += float((want ** 2).sum())
            leaves = [t.detach().cpu() for t in tp.tree_leaves(pg)]
            same = prev is not None and all(torch.equal(a, b) for a, b in zip(leaves, prev))
            prev = leaves
            print(f"{attn} run {i}: losses {loss:.4f} of the limit, update "
                  f"{(num / den) ** 0.5 / 1e-3:.4f} of the limit, params equal to the run "
                  f"before: {same}", flush=True)


def main(argv) -> int:
    runs = int(argv[0]) if argv else 20
    file_runs = int(argv[1]) if len(argv) > 1 else 5
    if not torch.cuda.is_available():
        raise SystemExit("card_test_repeat: needs a CUDA card")
    margins(runs)
    plugin = ["--noconftest", "-p", PLUGIN, "-q", "-s"]
    rcs = [subprocess.run([sys.executable, "-m", "pytest", *plugin, TEST, "-k", NAME],
                          env={**os.environ, "CARD_TEST_REPEAT": str(runs)}).returncode]
    for _ in range(file_runs):
        rcs.append(subprocess.run([sys.executable, "-m", "pytest", *plugin, TEST]).returncode)
    print(f"pytest exit codes: {NAME} x {runs}: {rcs[0]}; the whole file x {file_runs}: "
          f"{rcs[1:]}", flush=True)
    return int(any(rcs))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
