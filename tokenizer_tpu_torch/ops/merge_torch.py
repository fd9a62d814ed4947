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
of :func:`tokenizer_tpu.ops.pair_table.hash_pair_u32` runs in int64 with
every product split into 16-bit halves, which keeps each intermediate
below 2**49 and reduces mod 2**32 without relying on int64 overflow.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tokenizer_tpu.ops.pair_table import MAX_RANK

__all__ = ["device_table", "hash_slots", "lookup_pairs_torch", "merge_packed_torch"]

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_FIB = 0x9E3779B9
_U32 = 0xFFFFFFFF


def device_table(table, device) -> Dict[str, torch.Tensor]:
    """The pair table's arrays as contiguous int32 tensors on ``device``.

    ``table`` is a :class:`~tokenizer_tpu.ops.pair_table.PairTable` or the
    dict that :func:`tokenizer_tpu.ops.merge_jax.device_table` returns.
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
    for _ in range(max_probes):
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a packed [L, B] int32 tile. Returns (out_ids [L, B], out_n [B])."""
    L, B = ids.shape
    dev = ids.device
    ids = ids.clone()  # the result never aliases the caller's tile
    n = lengths.to(torch.int32, copy=True)
    row = torch.arange(L, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(B, device=dev)
    pad_ids = torch.full((1, B), -1, dtype=torch.int32, device=dev)
    pad_rank = torch.full((1, B), MAX_RANK, dtype=torch.int32, device=dev)

    def probe(left, right):
        return lookup_pairs_torch(tab, slot_bits, max_probes, left, right)

    if L >= 2:
        rank = probe(ids, torch.cat([ids[1:], pad_ids]))
    else:
        rank = torch.full((L, B), MAX_RANK, dtype=torch.int32, device=dev)
    rank = torch.where(row >= n[None, :] - 1, MAX_RANK, rank)

    it = 0
    while it < L - 1 and int(rank.min()) != MAX_RANK:
        j = torch.argmin(rank, dim=0).to(torch.int32)  # first min per column
        minrank = rank.min(dim=0).values
        active = minrank != MAX_RANK
        jb = j[None, :]

        # ids: row j <- merged id (== minrank); rows > j shift up.
        ids_shift = torch.cat([ids[1:], pad_ids])
        ids_new = torch.where(
            row < jb, ids, torch.where(row == jb, minrank[None, :], ids_shift)
        )
        ids = torch.where(active[None, :], ids_new, ids)
        n = torch.where(active, n - 1, n)

        # Re-probe the two pairs the merge touched.
        jl = j.long()
        id_jm1 = ids[(jl - 1).clamp(min=0), cols]
        id_j = ids[jl, cols]
        id_jp1 = ids[(jl + 1).clamp(max=L - 1), cols]
        probe_left = torch.where(j > 0, probe(id_jm1, id_j), MAX_RANK)
        probe_right = torch.where(j < n - 1, probe(id_j, id_jp1), MAX_RANK)

        rank_shift = torch.cat([rank[1:], pad_rank])
        rank_new = torch.where(
            row < jb - 1,
            rank,
            torch.where(
                row == jb - 1,
                probe_left[None, :],
                torch.where(row == jb, probe_right[None, :], rank_shift),
            ),
        )
        rank_new = torch.where(row >= n[None, :] - 1, MAX_RANK, rank_new)
        rank = torch.where(active[None, :], rank_new, rank)
        it += 1
    return ids, n
