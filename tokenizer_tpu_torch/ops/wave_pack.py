"""The span route's packer: a wave's tiles written natively into its upload buffer.

:func:`~tokenizer_tpu_torch.ops.packing.pack_spans` (a verbatim copy of
the JAX package's) builds each ``[L, B]`` tile through int64
temporaries and a ``np.where`` over the whole rectangle, and the wave
layout then copies every tile a second time into the upload buffer.  At
the card's long buckets (``gpu.DEVICE_BUCKETS``: L = 1024 and 2048) that
rectangle is most of a wave's dispatch.  Here the routing stays in
NumPy, as :func:`plan_spans` (cheap: per piece, not per byte), and the
fill is one native call, :func:`pack_wave` →
``runtime.native.pack_span_tiles``, which writes each cell of every
tile once, straight into the buffer that crosses to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..runtime import native
from .packing import BUCKETS, LANE, MAX_B, SpanPlan

__all__ = ["SpanTile", "plan_spans", "pack_wave"]


@dataclass(frozen=True)
class SpanTile:
    """One planned ``[l_max, width]`` tile whose first ``n_real`` columns
    carry pieces (the fields of ``PackedBatch`` without its arrays)."""

    l_max: int
    width: int
    n_real: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.l_max, self.width)


def plan_spans(
    buf,
    starts: np.ndarray,
    ends: np.ndarray,
    byte_to_id: np.ndarray,
    buckets: Tuple[int, ...] = BUCKETS,
    lane: int = LANE,
    b_quantum: Optional[int] = None,
) -> SpanPlan:
    """``pack_spans``' routing of a span wave, without filling a tile.

    The same bucket of each piece, the same length-sorted chunks of at
    most ``MAX_B`` columns, the same widths (``b_quantum * 2**k``), direct
    pieces (length <= 1, with their ids) and host pieces (longer than the
    widest bucket): the returned :class:`SpanPlan` equals ``pack_spans``'
    field for field, its ``batches`` being :class:`SpanTile`\\ s.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    lens = ends - starts
    quantum = b_quantum or lane
    max_b = max(MAX_B, quantum)
    bi = np.searchsorted(np.asarray(buckets, dtype=np.int64), lens, side="left")
    direct = lens <= 1
    bi[direct] = len(buckets) + 1  # in no bucket, and not a host piece
    batches: List[SpanTile] = []
    batch_piece_idx: List[np.ndarray] = []
    for b_i, L in enumerate(buckets):
        sel = np.nonzero(bi == b_i)[0]
        if sel.size > max_b:
            sel = sel[np.argsort(lens[sel], kind="stable")]
        for s0 in range(0, sel.size, max_b):
            chunk = sel[s0 : s0 + max_b]
            B = quantum
            while B < chunk.size:
                B *= 2
            batches.append(SpanTile(l_max=L, width=B, n_real=int(chunk.size)))
            batch_piece_idx.append(chunk)
    d_idx = np.nonzero(direct)[0]
    d_ids = np.full(d_idx.size, -1, dtype=np.int32)
    one = lens[d_idx] == 1
    if one.any():
        bview = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)
        d_ids[one] = byte_to_id[bview[starts[d_idx[one]]]]
    return SpanPlan(
        batches=batches,
        batch_piece_idx=batch_piece_idx,
        direct_idx=d_idx,
        direct_ids=d_ids,
        host_idx=np.nonzero(bi == len(buckets))[0],
    )


def pack_wave(
    buf,
    starts: np.ndarray,
    ends: np.ndarray,
    byte_to_id: np.ndarray,
    plan: SpanPlan,
    n_shards: int,
    out: np.ndarray,
) -> None:
    """Fill ``out``, the wave's flat int32 upload buffer, with ``plan``'s
    tiles in :func:`~tokenizer_tpu_torch.parallel.encode_step.dispatch_shards`'
    shard-major layout, in one native call (one thread).  Every tile's
    width must split into ``n_shards`` blocks.  Raises where the native
    library lacks the packer."""
    native.pack_span_tiles(
        buf,
        starts,
        ends,
        byte_to_id,
        np.array([(t.l_max, t.width, t.n_real) for t in plan.batches], dtype=np.int32),
        np.concatenate(plan.batch_piece_idx) if plan.batches else np.empty(0, np.int64),
        n_shards,
        out,
    )
