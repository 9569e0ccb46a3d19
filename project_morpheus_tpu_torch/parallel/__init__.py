"""Meshes, shardings and collectives over ``torch.distributed`` (port of
parallel/).

The JAX package's parallelism inventory, one process per device:

- FSDP (ZeRO-3) training over the ``data`` axis: each rank holds a shard
  of every parameter, gathers a layer's weights before use and
  reduce-scatters their gradients (``training/pretrain.py``);
- Megatron tensor parallelism over the ``model`` axis (``tensor.py``) for
  training (``fsdp_tp``) and serving (``OrpheusEngine(mesh=...)``);
- serving slots split over ``data``.

PP/EP/ring attention are non-goals, as in the JAX package.
"""

from .mesh import (
    Mesh,
    choose_backend,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
    mesh_shape_for,
    shutdown_distributed,
)
from .sharding import (
    Sharding,
    batch_shardings,
    engine_state_shardings,
    kv_cache_shardings,
    param_shardings,
    shard_params,
    shardings_like,
)

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "make_multihost_mesh",
    "mesh_shape_for",
    "param_shardings",
    "kv_cache_shardings",
    "engine_state_shardings",
    "batch_shardings",
    "shardings_like",
    "shard_params",
    "choose_backend",
    "shutdown_distributed",
    "Mesh",
    "Sharding",
]
