"""Distributed execution over ``torch.distributed``.

Data parallelism is the only axis for tokenization: each process
encodes its own corpus shard, and only small counter vectors cross
processes (:mod:`.multihost`).  In-process multi-GPU sharding (the JAX
package's ``mesh`` and ``encode_step``) is not ported yet.
"""

from .multihost import all_sum, in_distributed_job, initialize, process_info

__all__ = ["all_sum", "in_distributed_job", "initialize", "process_info"]
