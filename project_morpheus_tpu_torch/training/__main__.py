"""Training CLI (port of training/__main__.py):

    python -m project_morpheus_tpu_torch.training {pretrain,finetune,lora} \
        --config cfg.yaml [--device cpu]

YAML-config driven like the reference (pretrain/config.yaml,
finetune/config.yaml), with the JAX CLI's keys and casts; data is JSONL of
``{"input_ids": [...]}`` records.  The config is read with PyYAML's
``safe_load`` (so ``1e-3`` arrives as a string, which ``float`` takes, as in
the JAX CLI).  Runs on ``cuda`` unless ``--device cpu``.

Multi-process: launch one process per device with ``torchrun`` (or set
the JAX recipe's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``); ``parallel.initialize_distributed`` forms the group
and the ranks make a ``(data, tensor_parallel)`` mesh.  ``pretrain`` and
``finetune`` then train sharded, ``fsdp_tp`` when ``tensor_parallel`` > 1
and ``fsdp`` otherwise, each data rank on its strided
share of the records (``batch_size`` is per data rank, as in the JAX CLI),
logging and checkpoints on rank 0::

    torchrun --nproc_per_node 2 -m project_morpheus_tpu_torch.training \
        pretrain --config cfg.yaml

``lora`` trains on one device; under a mesh it raises.
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
    from ..parallel import initialize_distributed, make_mesh, make_multihost_mesh
    from ..parallel.mesh import STATE
    from ..utils.device import resolve_device
    from .data import BatchedRatioDataset, shard_for_rank
    from .pretrain import TrainConfig, train_loop

    tp = int(cfg_dict.get("tensor_parallel", 1))
    multi = initialize_distributed(device=args.device)
    dev = STATE.device or resolve_device(args.device)
    mesh = None
    if args.cmd == "lora" and (multi or tp > 1):
        raise NotImplementedError(
            f"lora trains on one device (tensor_parallel: {tp}, "
            f"{torch.distributed.get_world_size() if multi else 1} process(es))")
    if multi or tp > 1:
        mesh = (make_multihost_mesh if multi else make_mesh)(model=tp, device=dev)
    shard_mode = "fsdp_tp" if tp > 1 else "fsdp"

    def local(records: list) -> list:
        """This data rank's strided share (AlternatingDistributedSampler)."""
        if mesh is None:
            return records
        return shard_for_rank(records, mesh.coords["data"], mesh.shape["data"])
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
        # rank-0 logging, like the reference's rank-0 wandb stream
        if not multi or torch.distributed.get_rank() == 0:
            print(json.dumps(rec), flush=True)

    batch_size = int(cfg_dict.get("batch_size", 1))
    if args.cmd == "pretrain":
        text = local(_load_jsonl(cfg_dict["text_data"]))
        audio = local(_load_jsonl(cfg_dict["audio_data"]))
        ds = BatchedRatioDataset(text, audio, batch_size, ratio=int(cfg_dict.get("ratio", 1)))
        train_loop(params, model_cfg, iter(ds), tc=tc, mesh=mesh, log=log,
                   checkpoint_dir=ckpt_path, shard_mode=shard_mode, device=dev)
    elif args.cmd == "finetune":
        from .finetune import finetune

        data = local(_load_jsonl(cfg_dict["data"]))
        finetune(params, model_cfg, data, batch_size=batch_size, tc=tc, mesh=mesh, log=log,
                 checkpoint_dir=ckpt_path, device=dev, shard_mode=shard_mode)
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
    if multi:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
