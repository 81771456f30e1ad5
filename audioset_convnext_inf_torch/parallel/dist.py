"""Process-group bootstrap of the PyTorch port.

The counterpart of the JAX package's ``parallel/dist.py`` (the reference's
utils/idr_torch.py:8-23: SLURM environment -> NCCL rendezvous). One
process drives one card. ``initialize_distributed`` resolves the job in
this order:

 1. explicit arguments;
 2. the torchrun environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``);
 3. SLURM (``SLURM_NTASKS``, ``SLURM_PROCID``, ``SLURM_LOCALID``, the head
    of the step's node list, port 12345 + ``SLURM_JOBID`` % 10000, as the
    JAX package computes its coordinator);
 4. otherwise one process, and nothing to initialize.

A group of one process is still initialized when the environment names
one (``WORLD_SIZE=1``): the trainer then runs its collectives over it.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Optional

import torch
import torch.distributed as dist

# Only the primary evaluates during training, while the other ranks wait in
# their next all-reduce: the timeout has to outlast an evaluation of the
# whole eval set (about 20k clips) with room to spare.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=60)


def _slurm_head_node(nodelist: str) -> str:
    """First hostname of a SLURM node list: plain names (dashes included),
    comma lists and bracketed ranges ('node[001-004,007]' -> 'node001',
    'gpu-a[01-04]' -> 'gpu-a01')."""
    m = re.match(r"([^\[,]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.groups()
        return prefix + ranges.split(",")[0].split("-")[0]
    return nodelist.split(",")[0]


def resolve_job(init_method: Optional[str] = None, world_size: Optional[int] = None,
                rank: Optional[int] = None, local_rank: Optional[int] = None,
                environ=None) -> Optional[dict]:
    """The job this process belongs to, as ``{"init_method", "world_size",
    "rank", "local_rank"}``, or None for a lone process that no argument or
    environment names."""
    env = os.environ if environ is None else environ
    if world_size is None and "WORLD_SIZE" in env:  # torchrun
        world_size = int(env["WORLD_SIZE"])
        rank = int(env.get("RANK", 0)) if rank is None else rank
        local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
        if init_method is None:
            init_method = (f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:"
                           f"{env.get('MASTER_PORT', '29500')}")
    elif world_size is None and "SLURM_NTASKS" in env:
        world_size = int(env["SLURM_NTASKS"])
        rank = int(env.get("SLURM_PROCID", 0)) if rank is None else rank
        local_rank = int(env.get("SLURM_LOCALID", 0)) if local_rank is None else local_rank
        if init_method is None:
            nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
            head = _slurm_head_node(nodelist) if nodelist else "127.0.0.1"
            init_method = f"tcp://{head}:{12345 + int(env.get('SLURM_JOBID', '0')) % 10000}"
    if world_size is None:
        return None
    rank = 0 if rank is None else rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if init_method is None:
        raise ValueError("a process group needs an init_method (tcp://host:port or file://path)")
    return {"init_method": init_method, "world_size": world_size, "rank": rank,
            "local_rank": rank if local_rank is None else local_rank}


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, local_rank: Optional[int] = None,
                           backend: Optional[str] = None, device=None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the job's default process group; returns whether there is one.

    The backend is ``nccl`` on the card. ``device="cpu"`` asks for the CPU
    and the ``gloo`` backend; ``backend`` overrides the choice (``gloo`` also
    takes CUDA tensors). On the card this process drives card
    ``local_rank``, or the card ``device`` names; it must exist. Idempotent:
    a process already in a group keeps it."""
    if dist.is_initialized():
        return True
    job = resolve_job(init_method, world_size, rank, local_rank)
    if job is None:
        return False
    device = None if device is None else torch.device(device)
    cpu = device is not None and device.type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to train on "
                               "the CPU with the gloo backend")
        index = job["local_rank"] if device is None or device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"card {index} does not exist: this machine has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(index)
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=job["init_method"], world_size=job["world_size"],
                            rank=job["rank"], timeout=timeout)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank-0 gating for logging, statistics and checkpoints (reference
    main.py:287, 747)."""
    return rank() == 0
