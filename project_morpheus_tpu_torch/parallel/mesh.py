"""Process groups and the ``("data", "model")`` device mesh (port of
parallel/mesh.py).

One process drives one device.  Axis convention as in the JAX package:
DP/FSDP over ``data``, TP over ``model``; ranks lie row-major on the mesh
(``rank = data_index * model + model_index``), so a model group is a run
of consecutive ranks, the ranks of one host where the mesh spans hosts.

The backend follows one stated rule, logged when the group forms and kept
in :data:`STATE`, never swapped in silence:

- CPU: ``gloo``;
- CUDA with a card for each rank of the host (``LOCAL_WORLD_SIZE`` <=
  ``torch.cuda.device_count()``): ``nccl``;
- CUDA with ranks sharing a card: ``gloo`` (which carries CUDA tensors
  through the host, ``collectives.py``).  Asking for ``nccl`` there raises:
  NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

AXES = ("data", "model")


@dataclasses.dataclass
class DistState:
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    local_world_size: int = 1


STATE = DistState()


def choose_backend(device_type: str, local_world_size: int, n_cards: int,
                   requested: Optional[str] = None) -> str:
    """The backend rule of the module docstring."""
    if device_type == "cpu":
        if requested not in (None, "gloo"):
            raise ValueError(f"backend {requested!r} on the CPU: only gloo runs there")
        return "gloo"
    shared = local_world_size > n_cards
    if requested == "nccl" and shared:
        raise ValueError(
            f"nccl needs a card for each rank: {local_world_size} ranks on this host share "
            f"{n_cards} card(s); use gloo")
    if requested is not None:
        return requested
    return "gloo" if shared else "nccl"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> bool:
    """Bring up the default process group; returns True when more than one
    process takes part.

    Precedence: explicit args > torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (and ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) > the JAX recipe's ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.  A single process with none
    of these set is a no-op, as in the JAX package.  ``init_method`` is a
    ``tcp://host:port`` or ``file://`` store address.  Each rank's device
    is ``cuda:<LOCAL_RANK mod cards>`` (``device="cpu"``: the CPU); a stuck
    rendezvous or collective fails after ``timeout_s``.

    Launch recipe (one command per host)::

        torchrun --nnodes 1 --nproc_per_node 2 -m project_morpheus_tpu_torch.training \\
            pretrain --config cfg.yaml
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None:
        if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif env.get("JAX_COORDINATOR_ADDRESS"):
            init_method = f"tcp://{env['JAX_COORDINATOR_ADDRESS']}"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE") or _env_int("JAX_NUM_PROCESSES")
    if rank is None:
        rank = _env_int("RANK")
        if rank is None:
            rank = _env_int("JAX_PROCESS_ID")
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(
            f"incomplete process-group settings: init_method={init_method!r}, "
            f"world_size={world_size}, rank={rank}")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank % local_world
    dev = torch.device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        if n_cards == 0:
            raise RuntimeError("device 'cuda' requested but no card is visible; pass device='cpu'")
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    chosen = choose_backend(dev.type, local_world, n_cards, backend)
    kwargs = {}
    if chosen == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(chosen, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    STATE.backend, STATE.device, STATE.local_world_size = chosen, dev, local_world
    logger.info("process group: rank %d of %d, backend %s on %s (%d rank(s) on this host, "
                "%d card(s))", rank, world_size, chosen, dev, local_world, n_cards)
    return world_size > 1


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    STATE.backend, STATE.device = None, None


@dataclasses.dataclass
class Mesh:
    """A ``(data, model)`` mesh of ranks, this rank's place on it and the
    process groups of its axes.  With a live process group every axis has
    one, size 1 included (its collectives then really run, so a world of
    one over NCCL exercises them); without one there are none and every
    collective is a no-op."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    backend: Optional[str]
    device_mesh: object = None  # torch DeviceMesh when a process group is live
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    def group(self, axis: str):
        """Process group of ``axis`` (None without a process group)."""
        return self.groups.get(axis)

    def world_group(self):
        return dist.group.WORLD if self.groups else None


def _current_device(device) -> torch.device:
    """``device``, else the group's device, else the current card: a mesh
    runs on the card unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if STATE.device is not None:
        return STATE.device
    resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """``(data, model)`` mesh over every rank of the process group (one
    rank without a group: a 1 x 1 mesh whose collectives are no-ops)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    dev = _current_device(device)
    if not dist.is_initialized():
        return Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0}, dev, None)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)
    coords = {a: dm.get_local_rank(a) for a in AXES}
    groups = {a: dm.get_group(a) for a in AXES}
    return Mesh({"data": data, "model": model}, coords, dev, dist.get_backend(), dm, groups)


def make_multihost_mesh(model: int = 1, data: Optional[int] = None, device=None) -> Mesh:
    """``(data, model)`` mesh over every process's device; the TP degree
    must fit on one host so Megatron collectives never leave it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    local = STATE.local_world_size if dist.is_initialized() else 1
    if model > local:
        raise ValueError(
            f"tp={model} exceeds per-host device count {local}; the model axis must stay "
            f"within one host")
    return make_mesh(data, model, device)


def mesh_shape_for(n_devices: int, tp: Optional[int] = None) -> Tuple[int, int]:
    """Pick (data, model) given a device count and optional TP degree."""
    if tp is None:
        tp = 1
    if n_devices % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n_devices}")
    return n_devices // tp, tp
