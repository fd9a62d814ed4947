"""The sharded merge step: column shards over a :class:`~.mesh.DataMesh`.

The port's counterpart of :mod:`tokenizer_tpu.parallel.encode_step`.  A
packed tile's columns (lanes = pieces) split into ``mesh.size``
contiguous shards; the pair table is replicated, once per distinct
device.  Each shard runs the merge kernel on its own columns, on its own
stream; nothing crosses between shards but the two observability
counters (tokens out, live columns), summed as the JAX step ``psum``\\ s
them.  Those sums are this process's: a job's stay
:func:`~.multihost.all_sum` on gloo.

:func:`dispatch_shards` (:func:`launch_shards`), :func:`queue_fetch`
and :func:`read_fetch` own the wave layout, for this step and for
``GpuTokenizer``'s waves alike (one device is a mesh of one).
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
    "wave_layout",
    "wave_buffer",
    "dispatch_shards",
    "launch_shards",
    "queue_fetch",
    "read_fetch",
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


def wave_layout(shapes: Sequence[Tuple[int, int]], n: int) -> Tuple[int, int]:
    """For tiles of ``shapes`` (full ``[L, B]``) over ``n`` shards: the int32
    words of one shard's ids, and of its whole part (ids, then lengths)."""
    n_ids = sum(L * (B // n) for L, B in shapes)
    return n_ids, n_ids + sum(B // n for _, B in shapes)


def wave_buffer(shapes: Sequence[Tuple[int, int]], n: int, on_card: bool) -> torch.Tensor:
    """A wave's flat int32 host buffer in :func:`dispatch_shards`' layout:
    page-locked (torch's caching host allocator) for a card.  The wave's
    outputs come back in the same layout, into a buffer of the same size."""
    return torch.empty(wave_layout(shapes, n)[1] * n, dtype=torch.int32, pin_memory=on_card)


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
    (k+1)*B/n)`` of every tile.  The wave's ONE flat int32 host buffer
    (:func:`wave_buffer`) is laid out shard-major: for each shard, each
    tile's block of ids, then each tile's block of lengths (the JAX
    package's wave layout, ``tpu.py`` ``_dispatch_tiles``, per shard).
    The tiles are copied into it, then :func:`launch_shards` runs.
    Returns the merges' results shard by shard (``[k * len(tiles) + t]``)
    and the buffer, which must outlive the copies.
    """
    n = len(devices)
    shapes = [ids.shape for ids, _ in tiles]
    n_ids, part = wave_layout(shapes, n)
    host = wave_buffer(shapes, n, devices[0].type == "cuda")
    buf = host.numpy()
    for k in range(n):
        i, j = k * part, k * part + n_ids  # next tile's ids, lengths
        for ids, lengths in tiles:
            L, bs = ids.shape[0], ids.shape[1] // n
            cols = slice(k * bs, (k + 1) * bs)
            buf[i : i + L * bs].reshape(L, bs)[...] = ids[:, cols]
            buf[j : j + bs] = lengths[cols]
            i += L * bs
            j += bs
    return launch_shards(host, shapes, devices, streams, tabs, merge), host


def launch_shards(
    host: torch.Tensor,
    shapes: Sequence[Tuple[int, int]],
    devices: Sequence[torch.device],
    streams: Sequence,
    tabs: Dict[torch.device, Dict[str, torch.Tensor]],
    merge: Callable,
) -> list:
    """The launches of a wave already laid out in ``host``
    (:func:`dispatch_shards`' layout, tiles of ``shapes``): on a card each
    shard's part crosses in one ``non_blocking`` copy on the shard's
    stream and its tiles are views of the device copy; on the CPU the
    buffer serves in place.  Returns the merges' results shard by shard
    (``[k * len(shapes) + t]``)."""
    n = len(devices)
    n_ids, part = wave_layout(shapes, n)
    outs = []
    for k, (dev, stream) in enumerate(zip(devices, streams)):
        with on_stream(stream):
            flat = host[k * part : (k + 1) * part].to(dev, non_blocking=True)
            i, j = 0, n_ids
            for L, B in shapes:
                bs = B // n
                outs.append(merge(tabs[dev], flat[i : i + L * bs].view(L, bs), flat[j : j + bs]))
                i += L * bs
                j += bs
    return outs


def queue_fetch(outs: Sequence, n_tiles: int, streams: Sequence, back: torch.Tensor) -> list:
    """Queue the ``(out_ids, out_n)`` of :func:`launch_shards` back to the
    host right after the launches: per shard, one ``torch.cat`` and one
    copy into that shard's part of ``back`` (:func:`wave_buffer` of the
    same tiles), on the shard's stream.  On a card the copy is
    ``non_blocking`` into page-locked memory and is followed by an event
    recorded on that stream, so a wave is ready when its own kernels and
    copies are, whatever was queued after it; on the CPU the copy is made
    here.  Returns each shard's event (None on the CPU) for
    :func:`read_fetch`."""
    part = back.numel() // len(streams)
    done = []
    for k, stream in enumerate(streams):
        tiles = outs[k * n_tiles : (k + 1) * n_tiles]
        dst = back[k * part : (k + 1) * part]
        with on_stream(stream):
            flat = torch.cat([o.reshape(-1) for o, _ in tiles] + [c for _, c in tiles])
            if stream is None:
                dst.copy_(flat)
                done.append(None)
            else:
                dst.copy_(flat, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
                done.append(event)
    return done


def read_fetch(
    back: torch.Tensor, done: Sequence, shapes: Sequence[Tuple[int, int]]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Wait for each shard's copy of :func:`queue_fetch` (one event
    synchronize per shard on a card), then each tile's shards side by
    side.  Returns one ``(ids [L, B], n [B])`` pair of arrays per tile of
    ``shapes``, views of ``back`` on one shard."""
    for event in done:
        if event is not None:
            event.synchronize()
    n = len(done)
    n_ids, part = wave_layout(shapes, n)
    shards = [back[k * part : (k + 1) * part].numpy() for k in range(n)]
    out, off, cnt = [], 0, n_ids
    for L, B in shapes:
        bs = B // n
        blocks = [s[off : off + L * bs].reshape(L, bs) for s in shards]
        counts = [s[cnt : cnt + bs] for s in shards]
        out.append(
            (np.concatenate(blocks, axis=1), np.concatenate(counts)) if n > 1 else (blocks[0], counts[0])
        )
        off += L * bs
        cnt += bs
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
