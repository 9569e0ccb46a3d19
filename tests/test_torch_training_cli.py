"""The port's training CLI (``python -m project_morpheus_tpu_torch.training``)
on the CPU (``--device cpu``): pretrain, finetune and lora on the JAX CLI's
config keys, the lora run's merged checkpoint loadable, and a config
asking for ``tensor_parallel: 2`` refused.  The config's YAML reading is
held to the JAX CLI's (both ``yaml.safe_load``: ``1e-3`` is a string that
``float`` takes, ``bf16: false`` is falsy)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from project_morpheus_tpu.training import __main__ as jax_cli
from project_morpheus_tpu_torch.training import __main__ as cli
from project_morpheus_tpu_torch.training.checkpoint import restore_params

REPO = Path(__file__).resolve().parent.parent


def _write_jsonl(path, n, seed, length=8):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            fh.write(json.dumps({"input_ids": rng.integers(1, 1000, size=(length,)).tolist()}) + "\n")


def _run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "project_morpheus_tpu_torch.training", *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=240,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(cwd),
             "OMP_NUM_THREADS": "2"})


def _logs(res):
    assert res.returncode == 0, res.stderr[-2000:]
    return [json.loads(l) for l in res.stdout.splitlines() if l.startswith("{")]


def test_config_reading_matches_jax_cli(tmp_path):
    (tmp_path / "c.yaml").write_text(
        "learning_rate: 1e-3\nbf16: false\nseq_length: 8\nmodel_size: tiny_vocab\n")
    got = cli._load_yaml(str(tmp_path / "c.yaml"))
    assert got == jax_cli._load_yaml(str(tmp_path / "c.yaml"))
    assert got["learning_rate"] == "1e-3" and float(got["learning_rate"]) == 1e-3
    assert got["bf16"] is False


def test_pretrain_and_finetune_cli(tmp_path):
    _write_jsonl(tmp_path / "text.jsonl", 16, 0)
    _write_jsonl(tmp_path / "audio.jsonl", 8, 1)
    base = "model_size: tiny_vocab\nbatch_size: 4\ntotal_steps: 3\nseq_length: 8\n" \
           "learning_rate: 1e-3\nwarmup_steps: 1\nbf16: false\n"
    (tmp_path / "pre.yaml").write_text(
        base + f"text_data: {tmp_path}/text.jsonl\naudio_data: {tmp_path}/audio.jsonl\n"
        f"checkpoint_dir: {tmp_path}/pre\n")
    logs = _logs(_run_cli(["pretrain", "--config", str(tmp_path / "pre.yaml")], tmp_path))
    assert any("text_loss" in l for l in logs)  # step 0 (log_every 10)
    assert (tmp_path / "pre" / "step_3" / "params.safetensors").exists()
    (tmp_path / "ft.yaml").write_text(base + f"data: {tmp_path}/text.jsonl\n"
                                      f"resume_from: {tmp_path}/pre\n")
    logs = _logs(_run_cli(["finetune", "--config", str(tmp_path / "ft.yaml")], tmp_path))
    assert any("audio_loss" in l for l in logs)


def test_lora_cli_saves_merged_and_refuses_tp(tmp_path):
    _write_jsonl(tmp_path / "data.jsonl", 8, 2)
    cfg = f"model_size: tiny_vocab\ndata: {tmp_path}/data.jsonl\nbatch_size: 2\n" \
          f"total_steps: 2\nseq_length: 8\nlora_rank: 4\nbf16: false\n" \
          f"checkpoint_dir: {tmp_path}/ckpt\n"
    (tmp_path / "cfg.yaml").write_text(cfg)
    logs = _logs(_run_cli(["lora", "--config", str(tmp_path / "cfg.yaml")], tmp_path))
    assert any("lora_loss" in l for l in logs) and {"saved_merged": f"{tmp_path}/ckpt"} in logs
    merged = restore_params(tmp_path / "ckpt", step=2, device="cpu")
    assert merged["layers"]["wq"].shape == (2, 64, 64)
    assert (tmp_path / "ckpt" / "llama_config.json").exists()
    (tmp_path / "tp.yaml").write_text(cfg + "tensor_parallel: 2\n")
    res = _run_cli(["lora", "--config", str(tmp_path / "tp.yaml")], tmp_path)
    assert res.returncode != 0 and "NotImplementedError" in res.stderr
    assert "tensor_parallel" in res.stderr
