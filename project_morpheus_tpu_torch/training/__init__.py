"""Training on one card (port of training/; reference L0,
Orpheus-TTS/{pretrain,finetune}/).

- ``data``: interleaved text-QA / TTS batching (BatchedRatioDataset +
  AlternatingDistributedSampler equivalents) and the pad collator
  (pad 128263, labels -100).
- ``pretrain``: the autograd train step (full-sequence forward, chunked-vocab
  loss, AdamW with optax's clipping and schedule), grouped and per-layer
  layouts, the loop with split text/audio loss streams.
- ``finetune``: plain full-finetune loop.
- ``lora``: low-rank adapters on all projection matrices with rslora
  scaling and merge-and-save export.
- ``checkpoint``: the port's safetensors checkpoints (params, full trainer
  state, ``llama_config.json``), which ``ORPHEUS_CHECKPOINT_PATH`` serves.
- ``__main__``: ``python -m project_morpheus_tpu_torch.training
  {pretrain,finetune,lora} --config cfg.yaml [--device cpu]``.
"""

from .checkpoint import restore_params, save_params
from .data import BatchedRatioDataset, pad_collate, shard_for_rank
from .lora import LoraConfig, init_lora_params, lora_scale, merge_lora
from .pretrain import TrainConfig, make_train_step, train_loop

__all__ = [
    "BatchedRatioDataset",
    "pad_collate",
    "shard_for_rank",
    "TrainConfig",
    "make_train_step",
    "train_loop",
    "LoraConfig",
    "init_lora_params",
    "merge_lora",
    "lora_scale",
    "save_params",
    "restore_params",
]
