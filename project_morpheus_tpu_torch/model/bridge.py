"""Carry parameters from the JAX package into the port.

``params_from_jax_numpy`` takes a JAX parameter tree whose leaves were
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) and gives
the port's form: the same nesting of dicts and lists with torch tensors.
That covers plain leaves and int8 ``{"q", "scale"}`` leaves, fused
(``wqkv``/``wgu``) and separate layer weights, and the SNAC params dict
(lists of quantizer levels and decoder blocks, ``None`` for a missing
encoder), since every one of them is such a tree.  bf16 arrays (numpy's
``ml_dtypes`` bfloat16) arrive bit-exact as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def params_from_jax_numpy(tree, device="cpu"):
    """JAX params tree with numpy leaves -> the port's params on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return _leaf(tree, device)
