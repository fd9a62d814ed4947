"""Plain PyTorch version of the packed merge and its pair-table probe.

Bit-exact mirror of :func:`tokenizer_tpu.ops.merge_jax.merge_packed_jax`
and :func:`~tokenizer_tpu.ops.merge_jax.lookup_pairs`: the same ``[L, B]``
column-per-piece layout, one global-minimum merge per column per
iteration with the first index taken on ties (``torch.argmin`` returns
the first minimum), re-probing only pairs (j-1, j) and (j, j+1), and the
same ``it < L - 1`` trip bound.

It is the CPU route of :func:`tokenizer_tpu_torch.ops.merge_cuda.merge_packed`
and the oracle the CUDA kernel is held to on the card.

Torch on the CPU has no uint32 ``>>``, ``+`` or ``<``, so the Murmur mix
of :func:`.pair_table.hash_pair_u32` runs in int64 with
every product split into 16-bit halves, which keeps each intermediate
below 2**49 and reduces mod 2**32 without relying on int64 overflow.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .pair_table import MAX_RANK

__all__ = ["device_table", "hash_slots", "lookup_pairs_torch", "merge_packed_torch"]

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_FIB = 0x9E3779B9
_U32 = 0xFFFFFFFF


def device_table(table, device) -> Dict[str, torch.Tensor]:
    """The pair table's arrays as contiguous int32 tensors on ``device``.

    ``table`` is a :class:`~.pair_table.PairTable` (the port's or the JAX
    package's: anything with those three attributes) or a dict of the
    three arrays, like the one ``tokenizer_tpu.ops.merge_jax.device_table``
    returns.
    """
    get = table.__getitem__ if isinstance(table, dict) else lambda k: getattr(table, k)
    return {
        # np.array copies: the tensor owns writable, contiguous memory.
        k: torch.from_numpy(np.array(get(k), dtype=np.int32)).to(device)
        for k in ("key_left", "key_right", "values")
    }


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and constant ``c``."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def hash_slots(
    left: torch.Tensor, right: torch.Tensor, slot_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(home slot as int64, valid) of each pair; :func:`hash_pair_u32`
    of the pair with negative ids hashed as (0, 0), as every probe does."""
    valid = (left >= 0) & (right >= 0)
    l = torch.where(valid, left, 0).to(torch.int64)
    r = torch.where(valid, right, 0).to(torch.int64)
    h = _mul_u32(l, _C1) ^ _mul_u32(r, _C2)
    h = h ^ (h >> 16)
    return _mul_u32(h, _FIB) >> (32 - slot_bits), valid


def lookup_pairs_torch(
    tab: Dict[str, torch.Tensor],
    slot_bits: int,
    max_probes: int,
    left: torch.Tensor,
    right: torch.Tensor,
) -> torch.Tensor:
    """(left, right) -> merged id, MAX_RANK on a miss or a negative id.

    Same mix, probe order, full-key comparison and stop-at-empty as
    :meth:`PairTable.lookup`; any shape, int32 in and out.
    """
    slot, valid = hash_slots(left, right, slot_bits)
    mask = (1 << slot_bits) - 1

    kl_a, kr_a, vv_a = tab["key_left"], tab["key_right"], tab["values"]
    out = torch.full(left.shape, MAX_RANK, dtype=torch.int32, device=left.device)
    unresolved = valid
    # On the CPU the loop stops once every pair is resolved; on a card that
    # test would cost a sync a round, so it runs all max_probes rounds.
    on_cpu = left.device.type == "cpu"
    for _ in range(max_probes):
        if on_cpu and not bool(unresolved.any()):
            break
        kl = kl_a[slot]
        kr = kr_a[slot]
        hit = unresolved & (kl == left) & (kr == right)
        out = torch.where(hit, vv_a[slot], out)
        unresolved = unresolved & (kl != -1) & ~hit
        slot = (slot + 1) & mask
    return out


def merge_packed_torch(
    tab: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
    on_probe: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a packed [L, B] int32 tile. Returns (out_ids [L, B], out_n [B]).

    Only the probes the merge needs carry two valid ids: the adjacent
    pairs inside each piece, then the two pairs each merge touches.  Every
    other pair probed has a -1 in it and misses.  ``on_probe(left, right)``,
    if given, sees each probed pair tensor.

    Columns are independent, and one whose pairs all miss never changes
    again, so the loop works on the live columns only: those of length 2
    or more at the start, less each round the columns that have no pair
    left to merge, each written back to the output as it drops.  A tile
    whose long pieces sit among padding costs their columns, not ``B``.
    """
    L, B = ids.shape
    dev = ids.device
    out = ids.clone()  # the result never aliases the caller's tile
    out_n = lengths.to(torch.int32, copy=True)
    if L < 2:
        return out, out_n
    row = torch.arange(L, dtype=torch.int32, device=dev)[:, None]

    def probe(left, right):
        if on_probe is not None:
            on_probe(left, right)
        return lookup_pairs_torch(tab, slot_bits, max_probes, left, right)

    def shift_up(x, fill):
        """Rows 1.. of ``x`` moved up one, ``fill`` in the last row."""
        return torch.cat([x[1:], torch.full_like(x[:1], fill)])

    live = torch.nonzero(out_n >= 2).flatten()
    ids, n = out[:, live], out_n[live]
    rank = probe(torch.where(row < n[None, :] - 1, ids, -1), shift_up(ids, -1))

    it = 0
    while it < L - 1 and live.numel():
        minrank = rank.min(dim=0).values
        done = minrank == MAX_RANK
        if bool(done.any()):
            # No pair left in these columns: write them back and drop them.
            out[:, live[done]] = ids[:, done]
            out_n[live[done]] = n[done]
            keep = ~done
            live, ids, n, rank = live[keep], ids[:, keep], n[keep], rank[:, keep]
            continue
        cols = torch.arange(live.numel(), device=dev)
        j = torch.argmin(rank, dim=0).to(torch.int32)  # first min per column
        jb = j[None, :]

        # ids: row j <- merged id (== minrank); rows > j shift up.
        ids = torch.where(
            row < jb, ids, torch.where(row == jb, minrank[None, :], shift_up(ids, -1))
        )
        n = n - 1

        # Re-probe the two pairs the merge touched.
        jl = j.long()
        id_jm1 = ids[(jl - 1).clamp(min=0), cols]
        id_j = ids[jl, cols]
        id_jp1 = ids[(jl + 1).clamp(max=L - 1), cols]
        probe_left = probe(torch.where(j > 0, id_jm1, -1), id_j)
        probe_right = probe(id_j, torch.where(j < n - 1, id_jp1, -1))

        rank = torch.where(
            row < jb - 1,
            rank,
            torch.where(
                row == jb - 1,
                probe_left[None, :],
                torch.where(row == jb, probe_right[None, :], shift_up(rank, MAX_RANK)),
            ),
        )
        rank = torch.where(row >= n[None, :] - 1, MAX_RANK, rank)
        it += 1
    out[:, live] = ids
    out_n[live] = n
    return out, out_n
