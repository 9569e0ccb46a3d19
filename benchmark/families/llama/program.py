"""The llama family's inputs to the port's engine: the weight tree as
the configuration's ``engine.quant`` states it, and the port's
``LlamaConfig``.  With ``lib/program.py`` and ``lib/trace.py``, the only
kind of module here that imports the program.
"""
from __future__ import annotations

from typing import Dict

from .weights import dims


def llama_config(conf: Dict):
    from project_morpheus_tpu_torch.model.config import LlamaConfig

    d = dims(conf)
    return LlamaConfig(vocab_size=d["V"], hidden_size=d["D"], intermediate_size=d["F"],
                       num_layers=d["L"], num_heads=d["H"], num_kv_heads=d["KV"],
                       head_dim=d["HD"], max_seq_len=conf["engine"]["max_seq_len"],
                       rope_theta=d["theta"], rope_scaling_factor=1.0, rms_eps=d["eps"],
                       tie_embeddings=d["tied"], dtype=conf["engine"]["dtype"])


def engine_inputs(conf: Dict, params: Dict):
    """``(params as the engine takes them, the port's model config)``:
    ``quantize_params_int8`` where ``engine.quant`` is ``int8``."""
    from project_morpheus_tpu_torch.model.quant import quantize_params_int8

    if conf["engine"]["quant"] == "int8":
        params = quantize_params_int8(params)
    return params, llama_config(conf)
