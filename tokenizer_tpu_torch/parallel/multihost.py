"""Multi-process job plumbing over ``torch.distributed``.

The port's counterpart of :mod:`tokenizer_tpu.parallel.multihost`:
initialize the process group, tell a process its rank and the world
size, and sum small counter vectors across processes.  Bulk token ids
never cross processes: shards are independent, and order is restored by
stable shard indices.

Counters are host values, so :func:`all_sum` reduces them on a gloo
group (a default NCCL group would need CUDA tensors).  Single-process
callers never touch the backend.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["initialize", "in_distributed_job", "process_info", "all_sum"]

#: the gloo group that :func:`all_sum` reduces on, per default group
#: (None while the default group itself is gloo).
_GLOO_GROUPS: dict = {}


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> None:
    """``torch.distributed.init_process_group`` with env defaults.

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  The backend is gloo on a host without a card, and
    gloo for CPU tensors plus NCCL for CUDA tensors on one.  No-op
    when single-process (the common case) or when the group already
    exists, so callers can invoke it unconditionally.
    """
    import torch
    import torch.distributed as dist

    if world_size is None:
        world_size = _env_int("WORLD_SIZE") or 1
    if world_size == 1 and init_method is None:
        return
    if dist.is_initialized():
        return
    if rank is None:
        rank = _env_int("RANK")
        if rank is None:
            raise ValueError(
                f"world size {world_size} but no rank: pass rank= or set RANK"
            )
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo",
        init_method=init_method or "env://",
        world_size=world_size,
        rank=rank,
    )


def in_distributed_job() -> bool:
    """True when this process is (or may be) one rank of several.

    Checked without touching the backend: either a process group exists,
    or torchrun's ``WORLD_SIZE`` says more than one process was started
    (the part the Cloud TPU pod markers play in the JAX package: a
    launcher's environment alone must not collapse every rank to shard
    0 of 1).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    return (_env_int("WORLD_SIZE") or 1) > 1


def process_info() -> tuple:
    """``(rank, world_size)`` of this process; ``(0, 1)`` single-process.

    From the process group when it exists, else from torchrun's ``RANK``
    and ``WORLD_SIZE``.  A world size above one without a rank raises.
    """
    if not in_distributed_job():
        return 0, 1
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = _env_int("RANK")
    if rank is None:
        raise ValueError("WORLD_SIZE is above 1 but RANK is not set")
    return rank, _env_int("WORLD_SIZE")


def _gloo_group():
    """The default group where it reduces CPU tensors on gloo (as
    :func:`initialize` makes it), else a gloo group beside it."""
    import torch.distributed as dist

    if "gloo" in str(dist.get_backend()):
        return None
    key = id(dist.group.WORLD)
    if key not in _GLOO_GROUPS:
        _GLOO_GROUPS[key] = dist.new_group(backend="gloo")
    return _GLOO_GROUPS[key]


def all_sum(values: Sequence[float]) -> np.ndarray:
    """Global sum of a small counter vector: every PROCESS counts once.

    A float64 ``all_reduce`` on a gloo group; each process holds a
    different vector and every rank gets the sum.  A job known only from
    the environment initializes its group first (every rank calls this,
    so the rendezvous completes).  Single-process: returns the input
    unchanged, without touching the backend.
    """
    arr = np.asarray(values, dtype=np.float64)
    if not in_distributed_job():
        return arr
    import torch
    import torch.distributed as dist

    initialize()
    if dist.get_world_size() == 1:
        return arr
    t = torch.from_numpy(arr.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_gloo_group())
    return t.numpy()
