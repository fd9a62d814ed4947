"""The 1-D ``("data",)`` device mesh of one process (SURVEY.md §2.3).

The port's counterpart of :mod:`tokenizer_tpu.parallel.mesh`.  A
:class:`DataMesh` is one process over several devices, each taking a
contiguous block of a tile's columns; it is not
``torch.distributed.device_mesh.DeviceMesh``, which is one process per
device.  Processes of a job split the host's cards between them
(:func:`local_devices`), and each shards its own corpus shard over its
own cards.

A device may appear more than once: ``["cpu"] * 8`` is the CPU tests'
eight-shard mesh and ``["cuda:0"] * 2`` two shards of one card, each with
its own stream — the port's virtual mesh, in the place of the JAX
package's ``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "DataMesh",
    "data_mesh",
    "local_batch_size",
    "local_device_indices",
    "local_devices",
]


@dataclass(frozen=True)
class DataMesh:
    """Devices along one ``"data"`` axis; shard k runs on ``devices[k]``."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        if not devs:
            raise ValueError("a DataMesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) > 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a DataMesh takes cpu or cuda devices of one kind, not {devs}")
        if "cuda" in kinds:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            for d in devs:
                if d.index is None:
                    raise ValueError(f"mesh device {d} needs an index, as in cuda:0")
                if d.index >= count:
                    raise ValueError(f"mesh device {d} but only {count} card(s) visible")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def local_device_indices(
    device_count: int, local_rank: int = 0, local_world_size: int = 1
) -> List[int]:
    """The card indices that process ``local_rank`` of ``local_world_size``
    on one host owns.

    The ranks split the cards into contiguous blocks (the first
    ``device_count % local_world_size`` ranks take one card more).  With
    more ranks than cards, ranks share cards round-robin: rank k takes
    card ``k % device_count``.
    """
    if device_count <= 0:
        return []
    if not 0 <= local_rank < local_world_size:
        raise ValueError(f"local rank {local_rank} of {local_world_size}")
    if local_world_size >= device_count:
        return [local_rank % device_count]
    per, extra = divmod(device_count, local_world_size)
    start = local_rank * per + min(local_rank, extra)
    return list(range(start, start + per + (local_rank < extra)))


def local_devices() -> List[torch.device]:
    """The cards this process owns: the counterpart of ``jax.local_devices()``.

    Outside a job, every visible card.  In a job
    (:func:`~.multihost.in_distributed_job`), this rank's block of the
    host's cards by torchrun's ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    (without them, the job's rank and world size: one host), as
    :func:`local_device_indices` splits them.  Empty without a card.
    """
    from .multihost import in_distributed_job, process_info

    if not torch.cuda.is_available():
        return []
    count = torch.cuda.device_count()
    if not in_distributed_job():
        indices = list(range(count))
    else:
        rank, world = _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE")
        if rank is None or world is None:
            rank, world = process_info()
        indices = local_device_indices(count, rank, world)
    return [torch.device("cuda", i) for i in indices]


def data_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> DataMesh:
    """A 1-D ``("data",)`` mesh over ``devices`` (default: :func:`local_devices`),
    of its first ``n_devices`` where given."""
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            # Quietly building a smaller mesh than asked for once let a
            # "sharded" fuzz campaign run on one device: fail loudly.
            raise ValueError(
                f"data_mesh({n_devices}) but only {len(devices)} device(s) visible"
                " to this process; for a virtual mesh pass devices= with a"
                " device repeated, e.g. ['cpu'] * 8 or ['cuda:0'] * 2"
            )
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(
            "data_mesh(): no CUDA card visible to this process; pass devices="
            " (e.g. ['cpu'] * 8) for a mesh on the CPU"
        )
    return DataMesh(tuple(devices))


def local_batch_size(global_b: int, mesh: DataMesh) -> int:
    n = mesh.shape["data"]
    if global_b % n:
        raise ValueError(f"batch {global_b} not divisible by mesh size {n}")
    return global_b // n
