"""Full finetuning (port of training/finetune.py; reference
finetune/train.py:34-52).

A plain single-dataset loop over the pretraining step, one data stream.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

from ..model.config import LlamaConfig
from .pretrain import TrainConfig, train_loop


def finetune(
    params,
    cfg: LlamaConfig,
    examples: Sequence[dict],
    batch_size: int = 1,
    tc: Optional[TrainConfig] = None,
    mesh=None,
    log: Optional[Callable[[Dict], None]] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
    shard_mode: str = "fsdp",
) -> Tuple[Dict, Dict]:
    def batches() -> Iterable[Dict]:
        for i in range(0, len(examples) - batch_size + 1, batch_size):
            yield {"kind": "audio", "examples": list(examples[i : i + batch_size])}

    return train_loop(params, cfg, batches(), tc=tc, mesh=mesh, log=log,
                      checkpoint_dir=checkpoint_dir, shard_mode=shard_mode, device=device)
