"""Training CLI (port of training/__main__.py):

    python -m project_morpheus_tpu_torch.training {pretrain,finetune,lora} \
        --config cfg.yaml [--device cpu]

YAML-config driven like the reference (pretrain/config.yaml,
finetune/config.yaml), with the JAX CLI's keys and casts; data is JSONL of
``{"input_ids": [...]}`` records.  The config is read with PyYAML's
``safe_load`` (so ``1e-3`` arrives as a string, which ``float`` takes, as in
the JAX CLI).  Runs on ``cuda`` unless ``--device cpu``; one card only:
``tensor_parallel`` above 1 and multi-process launches raise.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _load_yaml(path: str) -> dict:
    import yaml

    return yaml.safe_load(Path(path).read_text()) or {}


def _load_jsonl(path: str) -> list:
    return [json.loads(l) for l in Path(path).read_text().splitlines() if l.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="project_morpheus_tpu_torch.training")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("pretrain", "finetune", "lora"):
        sp = sub.add_parser(name)
        sp.add_argument("--config", required=True)
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg_dict = _load_yaml(args.config)

    import torch

    from ..model import LlamaConfig
    from ..model.llama import init_llama_params
    from ..utils.device import resolve_device
    from .data import BatchedRatioDataset
    from .pretrain import TrainConfig, check_single_device, train_loop

    tp = int(cfg_dict.get("tensor_parallel", 1))
    if tp > 1:
        raise NotImplementedError(
            f"tensor_parallel: {tp}: the port trains on one card; tensor parallelism over "
            "NCCL waits in ROADMAP.md queue 1")
    check_single_device()
    dev = resolve_device(args.device)
    size = cfg_dict.get("model_size", "tiny")
    model_cfg = {
        "tiny": LlamaConfig.tiny,
        "tiny_vocab": LlamaConfig.tiny_vocab,
        "1b": LlamaConfig.orpheus_1b,
        "3b": LlamaConfig.orpheus_3b,
    }[size]()
    tc = TrainConfig(
        learning_rate=float(cfg_dict.get("learning_rate", 5e-5)),
        warmup_steps=int(cfg_dict.get("warmup_steps", 100)),
        total_steps=int(cfg_dict.get("epochs_steps", cfg_dict.get("total_steps", 1000))),
        seq_len=int(cfg_dict.get("seq_length", 8192)),
        save_steps=int(cfg_dict.get("save_steps", 5000)),
    )
    ckpt_path = cfg_dict.get("checkpoint_dir")
    resume = cfg_dict.get("resume_from")
    if resume:
        from .checkpoint import restore_params

        params = restore_params(resume, device=dev)
    else:
        params = init_llama_params(
            model_cfg, int(cfg_dict.get("seed", 0)), dev,
            dtype=torch.bfloat16 if cfg_dict.get("bf16", True) else torch.float32)

    def log(rec):
        print(json.dumps(rec), flush=True)

    batch_size = int(cfg_dict.get("batch_size", 1))
    if args.cmd == "pretrain":
        text = _load_jsonl(cfg_dict["text_data"])
        audio = _load_jsonl(cfg_dict["audio_data"])
        ds = BatchedRatioDataset(text, audio, batch_size, ratio=int(cfg_dict.get("ratio", 1)))
        train_loop(params, model_cfg, iter(ds), tc=tc, log=log, checkpoint_dir=ckpt_path,
                   device=dev)
    elif args.cmd == "finetune":
        from .finetune import finetune

        data = _load_jsonl(cfg_dict["data"])
        finetune(params, model_cfg, data, batch_size=batch_size, tc=tc, log=log,
                 checkpoint_dir=ckpt_path, device=dev)
    else:  # lora
        from .data import pad_collate
        from .lora import LoraConfig, init_lora_params, make_lora_train_step, merge_lora
        from .pretrain import make_optimizer

        lc = LoraConfig(rank=int(cfg_dict.get("lora_rank", 32)),
                        alpha=float(cfg_dict.get("lora_alpha", 64)))
        lora = init_lora_params(model_cfg, lc, 1, dev)
        opt = make_optimizer(tc)
        step = make_lora_train_step(model_cfg, lc, opt)
        opt_state = opt.init(lora)
        data = _load_jsonl(cfg_dict["data"])
        for i in range(tc.total_steps):
            batch_ex = data[(i * batch_size) % max(1, len(data) - batch_size):][:batch_size]
            if not batch_ex:
                break
            batch = pad_collate(batch_ex, max_len=tc.seq_len)
            lora, opt_state, loss = step(lora, opt_state, params, batch)
            if i % tc.log_every == 0:
                log({"step": i, "lora_loss": float(loss)})
        if ckpt_path:
            from .checkpoint import save_params

            save_params(ckpt_path, merge_lora(params, lora, lc), step=tc.total_steps,
                        cfg=model_cfg)
            log({"saved_merged": ckpt_path})
    return 0


if __name__ == "__main__":
    sys.exit(main())
