"""Process mesh over ``torch.distributed`` (counterpart of
``longcat_video_tta_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` with axes (data, context,
tensor) and lets XLA insert the collectives. Here one process (rank)
stands at each point of the mesh, the layout row-major as the
reference's ``devices.reshape(data, context, tensor)``:

    rank = (d * C + c) * T + t

and each axis gets one process group per line of the mesh along it, over
which ``parallel/collectives.py`` runs its explicit operations.

Axes: data (videos of a ``--video-parallel`` group, or batch rows),
context (the video-token axis: ring attention, ``context_attention.py``)
and tensor (Megatron-style sharding of the DiT's linears,
``sharding.py``).

Device and backend: rank r runs on ``cuda:(LOCAL_RANK % device_count)``,
on the CPU only when the caller asks for it. The backend is NCCL when
every rank of the host has a card of its own, and gloo on the CPU or
where ranks share a card (NCCL refuses two ranks on one GPU); gloo's
missing CUDA operations go through host buffers, and each gloo axis
line has ``collectives.STRIPES`` groups that carry a large message's
pieces at once (``collectives.py``). Every process group has a timeout, so a
collective that one rank never joins fails the run instead of hanging
it.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from . import collectives

AXES = ("data", "context", "tensor")
DEFAULT_TIMEOUT_S = 900.0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def rank_device(device="cuda", local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU when asked for, else
    ``cuda:(local_rank % device_count)`` (``LOCAL_RANK`` by default)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was requested but no CUDA GPU is available "
                           "(pass --device cpu to run the ranks on the CPU)")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", 0)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, requested: Optional[str] = None,
                   local_world: Optional[int] = None) -> str:
    """"nccl" when every rank on this host has a card of its own, "gloo"
    on the CPU or where ranks share a card. ``requested`` forces one;
    NCCL for ranks that share a card raises (NCCL refuses it)."""
    device = torch.device(device)
    if local_world is None:
        local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    shared = device.type == "cuda" and local_world > torch.cuda.device_count()
    if requested not in (None, "", "auto"):
        if requested not in ("nccl", "gloo"):
            raise ValueError(f"backend {requested!r}: one of nccl, gloo")
        if requested == "nccl" and (device.type != "cuda" or shared):
            raise ValueError(
                f"backend nccl needs one card per rank: {local_world} ranks on this "
                f"host, {torch.cuda.device_count() if device.type == 'cuda' else 0} "
                f"cards (ranks that share a card run over gloo)")
        return requested
    return "nccl" if device.type == "cuda" and not shared else "gloo"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *,
                     device="cuda", backend: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group (the reference's ``init_distributed``).

    Already joined (by torchrun's launch here, or by the caller): True.
    Without a coordinator (no ``init_method`` and no ``MASTER_ADDR`` in
    the environment, i.e. not launched by ``torchrun``) this is a no-op
    that returns False, as the reference's is without
    ``JAX_COORDINATOR_ADDRESS``. Otherwise the
    world size, rank and local rank come from the arguments or from
    torchrun's ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; the backend
    from ``choose_backend``; the group gets a ``timeout_s`` timeout.
    Returns True."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if os.environ.get("MASTER_ADDR") is None:
            return False
        init_method = "env://"
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else int(world_size)
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    dev = rank_device(device, local_rank)
    chosen = choose_backend(dev, backend, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(chosen, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclass
class Mesh:
    """This rank's place in a (data, context, tensor) mesh and the process
    group of each axis (None for an axis of size 1)."""

    cfg: MeshConfig
    rank: int
    device: torch.device
    backend: Optional[str] = None
    groups: Dict[str, object] = field(default_factory=dict)
    members: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.cfg.data, "context": self.cfg.context,
                "tensor": self.cfg.tensor}

    @property
    def axis_names(self):
        return AXES

    @property
    def coords(self) -> Dict[str, int]:
        C, T = self.cfg.context, self.cfg.tensor
        return {"data": self.rank // (C * T), "context": (self.rank // T) % C,
                "tensor": self.rank % T}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def describe(self) -> Dict[str, object]:
        """The record a run keeps in its config.json."""
        return {"backend": self.backend, "world": self.cfg.num_devices, "rank": self.rank,
                "mesh": dict(self.shape), "device": str(self.device)}


def _axis_members(cfg: MeshConfig, axis: str) -> List[List[int]]:
    """Every line of the mesh along ``axis``, as lists of ranks."""
    D, C, T = cfg.data, cfg.context, cfg.tensor
    rank = lambda d, c, t: (d * C + c) * T + t
    if axis == "data":
        return [[rank(d, c, t) for d in range(D)] for c in range(C) for t in range(T)]
    if axis == "context":
        return [[rank(d, c, t) for c in range(C)] for d in range(D) for t in range(T)]
    return [[rank(d, c, t) for t in range(T)] for d in range(D) for c in range(C)]


def build_mesh(cfg: MeshConfig, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh of ``cfg`` over the joined process group, whose world size
    must be ``cfg.num_devices``; a one-point mesh needs no process group.
    ``device`` is this rank's card by default (``rank_device``, which
    raises without one); the CPU only when passed. Every rank creates
    every axis group, in one order (the collective ``new_group``
    contract), and keeps its own."""
    n = cfg.num_devices
    device = rank_device() if device is None else torch.device(device)
    if n == 1 and not dist.is_initialized():
        return Mesh(cfg, 0, device)
    if not dist.is_initialized():
        raise ValueError(f"mesh {cfg} needs {n} ranks: join a process group first "
                         f"(init_distributed, or launch with torchrun)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {cfg} needs {n} ranks, the process group has {world}")
    rank = dist.get_rank()
    mesh = Mesh(cfg, rank, device, dist.get_backend())
    timeout = datetime.timedelta(seconds=timeout_s)
    # gloo carries a large message over several groups of the same ranks
    n_groups = collectives.STRIPES if mesh.backend == "gloo" else 1
    for axis in AXES:
        if mesh.size(axis) == 1:
            continue
        for members in _axis_members(cfg, axis):
            g, *stripes = (dist.new_group(members, timeout=timeout)
                           for _ in range(n_groups))
            if rank in members:
                mesh.groups[axis] = g
                mesh.members[axis] = members
                collectives.add_stripes(g, stripes)
    return mesh


def factorize_devices(n: int) -> MeshConfig:
    """(data, context, tensor) for n ranks, every one on the context axis,
    as the reference's heuristic (ring attention scales the dominant cost;
    callers that need tensor parallelism pass a MeshConfig)."""
    return MeshConfig(data=1, context=n, tensor=1)


def single_device_mesh(device=None) -> Mesh:
    """The one-point mesh: no process group, every collective a no-op. On
    this rank's card by default; the CPU only when passed."""
    return Mesh(MeshConfig(), 0, rank_device() if device is None else torch.device(device))
