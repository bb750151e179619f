"""Multi-process runtime initialization over ``torch.distributed``.

Counterpart of ``cytvdn_tpu/parallel/distributed.py::init_distributed``.
The reference's scale-out entry is ``mpirun``/SLURM launching one MPI rank
per node (reference cyTVDN/mpi.py:31-33); here it is one Python process per
shard, started by ``torchrun`` (or anything that sets its environment:
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), joined into one process group.

The backend follows one rule, logged at initialization: ``nccl`` where
every rank of a host has a card of its own (``LOCAL_WORLD_SIZE`` ≤ the
host's cards), ``gloo`` where ranks share a card (NCCL refuses two ranks
on one device) or run on the CPU. A caller may name the backend; nothing
switches it after a failure. The group gets a finite timeout, so a
deadlocked collective raises instead of hanging.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

log = logging.getLogger("cytvdn_tpu_torch.parallel")

#: the default timeout of the process group's collectives
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

_device: Optional[torch.device] = None


def choose_backend(local_world: int, n_cards: int, device_type: str) -> str:
    """The backend rule: ``nccl`` when the ranks of a host each have a card
    of their own, ``gloo`` when they share one or run on the CPU."""
    if device_type != "cuda" or n_cards < 1 or local_world > n_cards:
        return "gloo"
    return "nccl"


def rank_device(local_rank: int, device: Union[str, torch.device] = "cuda"
                ) -> torch.device:
    """The device of a rank: ``cuda:{LOCAL_RANK % device_count}``, or the
    CPU when the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("init_distributed: no CUDA device (pass "
                           "device='cpu' to run the ranks on the CPU)")
    return torch.device("cuda", local_rank % n)


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the process group if this looks like a multi-process launch;
    a no-op returning False otherwise.

    The arguments default to torchrun's environment: ``world_size`` to
    ``WORLD_SIZE``, ``rank`` to ``RANK``, ``init_method`` to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``). Each rank's device is
    ``cuda:{LOCAL_RANK % device_count}`` (made current), or the CPU with
    ``device="cpu"``. ``backend`` forces ``"nccl"`` or ``"gloo"``; by
    default :func:`choose_backend` decides. Returns True once the group is
    up (also when it already was)."""
    global _device
    if dist.is_initialized():
        return True
    env_ws = os.environ.get("WORLD_SIZE")
    if world_size is None and env_ws:
        world_size = int(env_ws)
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size is None or rank is None:
        return False
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(local_rank, device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    rule = choose_backend(local_world, n_cards, dev.type)
    chosen = backend or rule
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info("init_distributed: rank %d of %d on %s, backend %s (%s; %d "
             "ranks on this host, %d cards)", rank, world_size, dev, chosen,
             "forced" if backend else "the rule", local_world, n_cards)
    dist.init_process_group(
        chosen, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=timeout)
    _device = dev
    return True


def distributed_device() -> Optional[torch.device]:
    """The device :func:`init_distributed` gave this rank, or None before
    it has set up a group."""
    return _device
