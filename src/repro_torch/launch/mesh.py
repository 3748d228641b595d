"""Client process groups for the sharded reducer — port of
`repro.launch.mesh.make_client_mesh`.

The reference shards the fleet's client axis over a 1-D device mesh.  The
port shards it over the ranks of a `torch.distributed` world: rank r of
the first ``ndev`` ranks holds clients ``[r·n/ndev, (r+1)·n/ndev)``, and
`repro_torch.core.rounds.ShardedReducer` runs the cross-client reductions
as collectives over their group.

  * ``ndev`` is the reference's rule: the largest divisor of n that is at
    most the world size, so every shard holds n/ndev clients (n = 10 at
    W = 4 gives ndev = 2).  Ranks past ``ndev`` sit out of the collectives
    and receive the run's result from rank 0 (`ClientGroup.share`).
  * The world comes from the usual environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets it), or from a
    caller that initialized the process group itself.  With no world (one
    process) the group is a one-rank world whose collectives are
    identities: the reference's one-device mesh.
  * The process-group backend follows one rule (`backend_rule`): NCCL when
    the ranks run on CUDA and each has a card of its own, gloo when ranks
    share a card or run on the CPU.  gloo moves CUDA tensors through host
    memory; it is how W ranks share one card, for correctness, not speed.
    A failed NCCL init raises: nothing falls back to gloo.
  * Collectives time out after ``REPRO_DIST_TIMEOUT_S`` seconds (default
    120), so a rank killed mid-run ends its peers with an error instead of
    a hang.

The LM's production meshes (the reference's `make_production_mesh`,
`make_debug_mesh`) belong to LM sharding, ROADMAP.md §1 item 18.7.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import pickle
from typing import Optional

import torch
import torch.distributed as dist

#: default collective timeout, seconds (``REPRO_DIST_TIMEOUT_S``)
DEFAULT_TIMEOUT_S = 120.0


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def backend_rule(device: torch.device, world: int, local_world: int) -> str:
    """The process-group backend for ``world`` ranks, ``local_world`` of
    them on this host: ``"nccl"`` when the ranks run on CUDA and the host
    has a card for each local rank, else ``"gloo"`` (ranks sharing one card,
    or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_from_env(device=None) -> Optional[str]:
    """Initialize the default process group from the ``torchrun``
    environment when it names a world of more than one rank and no group
    exists yet; returns the backend in use (None for a one-rank world).

    ``device`` is the run's device (None: CUDA).  Under NCCL each rank
    binds its local card (``LOCAL_RANK``)."""
    if dist.is_initialized():
        return dist.get_backend()
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return None
    dev = torch.device("cuda" if device is None else device)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    backend = backend_rule(dev, world, local_world)
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0))
    timeout = datetime.timedelta(
        seconds=float(os.environ.get("REPRO_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S)))
    dist.init_process_group(backend, rank=_env_int("RANK", 0), world_size=world,
                            timeout=timeout)
    return backend


def world() -> tuple:
    """``(rank, world size)`` of this process; ``(0, 1)`` without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank0(log):
    """``log`` on rank 0 of the world, a no-op elsewhere: every rank runs a
    sharded sweep or serve, one of them reports and writes."""
    return log if world()[0] == 0 else (lambda *args, **kwargs: None)


@dataclasses.dataclass(frozen=True)
class ClientGroup:
    """The ranks that hold a fleet of ``n`` clients.

    ``group`` is the process group of the first ``ndev`` ranks (None when
    ``ndev == 1``: collectives are identities), ``rank`` and ``world_size``
    this process's place in the world, ``backend`` the process-group
    backend (``"none"`` for a one-rank world)."""

    n: int
    ndev: int
    rank: int
    world_size: int
    backend: str
    group: Optional[object] = None

    @property
    def active(self) -> bool:
        """True on the ranks that hold clients."""
        return self.rank < self.ndev

    @property
    def n_local(self) -> int:
        return self.n // self.ndev

    @property
    def client_slice(self) -> slice:
        """This rank's clients (an empty slice off the group)."""
        if not self.active:
            return slice(0, 0)
        lo = self.rank * self.n_local
        return slice(lo, lo + self.n_local)

    def describe(self) -> dict:
        """The record of how the run was laid out."""
        return {"world_size": self.world_size, "ndev": self.ndev,
                "n_local": self.n_local, "backend": self.backend}

    def share(self, obj):
        """``obj`` as rank 0 holds it, on every rank of the world: ranks
        off the group take no part in the run's collectives and receive its
        result here.  Tensors travel on the host and land on the CPU, or on
        this rank's card if they left from one.  The identity when every
        rank is in the group."""
        if self.world_size == self.ndev:
            return obj
        payload = [pickle.dumps(_to_host(obj)) if self.rank == 0 else None]
        dist.broadcast_object_list(payload, src=0)
        return _from_host(pickle.loads(payload[0]))


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return ("__tensor__", obj.detach().cpu(), obj.is_cuda)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def _from_host(obj):
    if isinstance(obj, tuple) and len(obj) == 3 and obj[0] == "__tensor__":
        return obj[1].cuda() if obj[2] else obj[1]
    if isinstance(obj, dict):
        return {k: _from_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _from_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


@functools.lru_cache(maxsize=None)
def _group_of(ndev: int, world_size: int):
    # new_group is collective over the whole world: every rank calls it, in
    # the same order, also the ranks it leaves out
    if ndev == world_size:
        return dist.group.WORLD
    return dist.new_group(ranks=list(range(ndev)))


def client_group(n_clients: int, device=None) -> ClientGroup:
    """The client group for a fleet of ``n_clients`` (the counterpart of
    the reference's ``make_client_mesh``): initializes the world from the
    environment if needed (`init_from_env`), then spans the most ranks
    that evenly divide the client count.  Every rank of the world must
    call it, with the same count."""
    init_from_env(device)
    rank, size = world()
    ndev = max(k for k in range(1, size + 1) if n_clients % k == 0)
    if size == 1:
        return ClientGroup(n=n_clients, ndev=1, rank=0, world_size=1, backend="none")
    group = _group_of(ndev, size) if ndev > 1 else None
    return ClientGroup(n=n_clients, ndev=ndev, rank=rank, world_size=size,
                       backend=dist.get_backend(), group=group)
