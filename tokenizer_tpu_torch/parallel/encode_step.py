"""The sharded merge step: column shards over a :class:`~.mesh.DataMesh`.

The port's counterpart of :mod:`tokenizer_tpu.parallel.encode_step`.  A
packed tile's columns (lanes = pieces) split into ``mesh.size``
contiguous shards; the pair table is replicated, once per distinct
device.  Each shard runs the merge kernel on its own columns, on its own
stream; nothing crosses between shards but the two observability
counters (tokens out, live columns), summed as the JAX step ``psum``\\ s
them.  Those sums are this process's: a job's stay
:func:`~.multihost.all_sum` on gloo.

:func:`dispatch_shards` and :func:`fetch_shards` own the wave layout,
for this step and for ``GpuTokenizer``'s waves alike (one device is a
mesh of one).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import merge_cuda
from ..ops.merge_cuda import LANE
from ..ops.merge_torch import device_table
from .mesh import DataMesh, local_batch_size

__all__ = [
    "sharded_merge_step",
    "make_sharded_merge_fn",
    "gather_shards",
    "replicate_table",
    "shard_streams",
    "dispatch_shards",
    "fetch_shards",
]


def sharded_merge_step(
    tab: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
):
    """One shard's body: merge its columns (the kernel on a card, the
    plain version on the CPU), count its tokens out and live columns.

    Returns ``(out_ids, out_n, counters)``, counters ``[2]`` int64 on the
    shard's device."""
    out_ids, out_n = merge_cuda.merge_packed(
        tab, ids, lengths, slot_bits=slot_bits, max_probes=max_probes
    )
    counters = torch.stack([out_n.sum(), (lengths > 0).sum()])
    return out_ids, out_n, counters


def replicate_table(table, devices: Sequence[torch.device]) -> Dict[torch.device, Dict[str, torch.Tensor]]:
    """The pair table on each distinct device, uploaded once."""
    return {d: device_table(table, d) for d in dict.fromkeys(devices)}


def shard_streams(devices: Sequence[torch.device]) -> List:
    """A stream of its own for each shard on a card (two shards of one
    card overlap); None for a CPU shard.  Each new stream waits for what
    its device's current stream has queued so far: the table's upload."""
    streams = []
    for d in devices:
        stream = None
        if d.type == "cuda":
            stream = torch.cuda.Stream(device=d)
            stream.wait_stream(torch.cuda.current_stream(d))
        streams.append(stream)
    return streams


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for a CPU shard."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def dispatch_shards(
    tiles: Sequence[Tuple[np.ndarray, np.ndarray]],
    devices: Sequence[torch.device],
    streams: Sequence,
    tabs: Dict[torch.device, Dict[str, torch.Tensor]],
    merge: Callable,
) -> Tuple[list, torch.Tensor]:
    """One upload per shard for a wave of host tiles, then
    ``merge(tab, ids, lengths)`` once per tile and shard, on the shard's
    stream.

    ``tiles`` are ``(ids [L, B], lengths [B])`` int32 arrays, each B a
    multiple of ``len(devices)``; shard k takes columns ``[k*B/n,
    (k+1)*B/n)`` of every tile.  The wave's ONE flat int32 host buffer is
    laid out shard-major: for each shard, each tile's block of ids, then
    each tile's block of lengths (the JAX package's wave layout,
    ``tpu.py`` ``_dispatch_tiles``, per shard).  On a card it is
    page-locked, from torch's caching host allocator, and each shard's
    part crosses in one ``non_blocking`` copy; the tiles are views of the
    device copies.  On the CPU the buffer serves in place.  Returns the
    merges' results shard by shard (``[k * len(tiles) + t]``) and the
    buffer, which must outlive the copies.
    """
    n = len(devices)
    shapes = [(ids.shape[0], ids.shape[1] // n) for ids, _ in tiles]
    n_ids = sum(L * bs for L, bs in shapes)  # one shard's ids
    part = n_ids + sum(bs for _, bs in shapes)  # and its lengths
    on_card = devices[0].type == "cuda"
    host = torch.empty(part * n, dtype=torch.int32, pin_memory=on_card)
    buf = host.numpy()
    outs = []
    for k, (dev, stream) in enumerate(zip(devices, streams)):
        base = k * part
        i, j = base, base + n_ids  # next tile's ids, lengths
        for (ids, lengths), (L, bs) in zip(tiles, shapes):
            cols = slice(k * bs, (k + 1) * bs)
            buf[i : i + L * bs].reshape(L, bs)[...] = ids[:, cols]
            buf[j : j + bs] = lengths[cols]
            i += L * bs
            j += bs
        with on_stream(stream):
            flat = host[base : base + part].to(dev, non_blocking=True)
            i, j = 0, n_ids
            for L, bs in shapes:
                outs.append(merge(tabs[dev], flat[i : i + L * bs].view(L, bs), flat[j : j + bs]))
                i += L * bs
                j += bs
    return outs, host


def fetch_shards(outs: Sequence, n_tiles: int, streams: Sequence) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The ``(out_ids, out_n)`` of :func:`dispatch_shards` back on the host:
    one ``torch.cat`` and one device-to-host copy per shard, on the
    shard's stream (queued after its kernels, which are queued after its
    upload), then each tile's shards side by side.  Returns one
    ``(ids [L, B], n [B])`` pair of arrays per tile."""
    shards = []
    for k, stream in enumerate(streams):
        part = outs[k * n_tiles : (k + 1) * n_tiles]
        with on_stream(stream):
            shards.append(
                torch.cat([o.reshape(-1) for o, _ in part] + [c for _, c in part]).cpu().numpy()
            )
    n = len(shards)
    tiles, off = [], 0
    for o, _ in outs[:n_tiles]:
        L, bs = o.shape
        tiles.append(
            np.concatenate([s[off : off + L * bs].reshape(L, bs) for s in shards], axis=1)
            if n > 1
            else shards[0][off : off + L * bs].reshape(L, bs)
        )
        off += L * bs
    out = []
    for ids, (_, c) in zip(tiles, outs[:n_tiles]):
        bs = c.shape[0]
        out.append((ids, np.concatenate([s[off : off + bs] for s in shards])))
        off += bs
    return out


def make_sharded_merge_fn(table, mesh: DataMesh):
    """``fn(ids [L, B], lengths [B])`` for a host tile, sharded on B.

    B must be a multiple of ``LANE * mesh.size``.  Each shard's columns
    and lengths go up in one copy (:func:`dispatch_shards`) and merge on
    the shard's stream (:func:`sharded_merge_step`).  Returns
    ``(out_ids, out_n, counters)``: per-shard lists of ``[L, B/n]`` and
    ``[B/n]`` tensors on their devices, and the ``[2]`` sum of the
    shards' counters (tokens out, live columns) on the first shard's
    device.  The callers' current streams wait for the shard streams, so
    the outputs may be read there; :func:`gather_shards` brings them to
    the host in column order.
    """
    tabs = replicate_table(table, mesh.devices)
    streams = shard_streams(mesh.devices)

    def step(tab, ids, lengths):
        return sharded_merge_step(
            tab, ids, lengths, slot_bits=table.slot_bits, max_probes=table.max_probes
        )

    def fn(ids, lengths):
        ids = np.asarray(ids, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        bs = local_batch_size(ids.shape[1], mesh)
        if bs % LANE:
            raise ValueError(
                f"batch {ids.shape[1]}: each of {mesh.size} shards needs a multiple of {LANE} columns"
            )
        outs, _host = dispatch_shards([(ids, lengths)], mesh.devices, streams, tabs, step)
        for dev, stream, ts in zip(mesh.devices, streams, outs):
            if stream is not None:
                here = torch.cuda.current_stream(dev)
                here.wait_stream(stream)
                for t in ts:
                    t.record_stream(here)
        first = mesh.devices[0]
        counters = torch.stack([c.to(first) for _, _, c in outs]).sum(0)
        return [o for o, _, _ in outs], [c for _, c, _ in outs], counters

    return fn


def gather_shards(
    out_ids: Sequence[torch.Tensor], out_n: Sequence[torch.Tensor]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-shard ``[L, B/n]`` ids and ``[B/n]`` counts -> host ``[L, B]``
    and ``[B]`` arrays, shards side by side in column order."""
    return (
        np.concatenate([o.cpu().numpy() for o in out_ids], axis=1),
        np.concatenate([c.cpu().numpy() for c in out_n]),
    )
