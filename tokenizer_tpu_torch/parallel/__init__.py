"""Data parallelism: in one process over its cards, and across processes.

Data parallelism is the only axis for tokenization.  Inside a process,
:mod:`.mesh` lays its cards (or CPU shards) along one ``"data"`` axis and
:mod:`.encode_step` merges each tile's column shards on them, with the
pair table replicated and the two counters summed.  Across processes,
each encodes its own corpus shard, and only small counter vectors cross
(:mod:`.multihost`, torch.distributed).  :mod:`.dryrun` drives the mesh
path end to end.
"""

from .encode_step import gather_shards, make_sharded_merge_fn, sharded_merge_step
from .mesh import DataMesh, data_mesh, local_batch_size, local_devices
from .multihost import all_sum, in_distributed_job, initialize, process_info

__all__ = [
    "DataMesh",
    "data_mesh",
    "local_batch_size",
    "local_devices",
    "sharded_merge_step",
    "make_sharded_merge_fn",
    "gather_shards",
    "all_sum",
    "in_distributed_job",
    "initialize",
    "process_info",
]
