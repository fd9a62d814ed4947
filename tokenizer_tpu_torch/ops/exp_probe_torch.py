"""Table layouts and plain PyTorch versions of the pair-table probe experiments.

The JAX package tried three Pallas formulations of ``PairTable.lookup``
against a full-vocabulary table (``tokenizer_tpu/ops/exp_pallas_dma.py``
and ``exp_pallas_bigtable.py``).  All three compute the same function;
they differ in how a probe's table row reaches the compute unit:

* K3 ``probe_pallas_dma`` and K4 ``probe_pallas_vmem`` read the three
  ``[n_rows, 128]`` planes of :func:`table_planes_2d` row by row, slot
  ``s`` at ``[s >> 7, s & 127]``; their plain version here is
  :func:`probe_rows_torch`;
* K5 ``lookup_onehot_pallas`` fetches each probe's row with a one-hot
  matrix product over the int8 byte planes of
  :func:`bigtable_device_table`; its plain version is
  :func:`lookup_onehot_torch`.

Both plain versions always run the table's ``max_probes`` rounds, as the
Pallas kernels do, and give ``MAX_RANK`` on a miss or a negative id.
They are the CPU route of :mod:`.probe_cuda`'s wrappers and the oracles
its CUDA kernels are held to on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .merge_torch import hash_slots
from .pair_table import MAX_RANK

__all__ = [
    "LANES",
    "bigtable_device_table",
    "lookup_onehot_torch",
    "probe_rows_torch",
    "table_planes_2d",
]

#: Slots per table row: one TPU vreg of lanes in the JAX layouts.
LANES = 128

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def table_planes_2d(table, device) -> Planes:
    """``(key_left, key_right, values)`` as ``[n_rows, 128]`` int32 planes.

    Counterpart of ``tokenizer_tpu.ops.exp_pallas_dma.table_planes_2d``.
    ``table`` is a :class:`~tokenizer_tpu.ops.pair_table.PairTable` or
    that function's 3-tuple, as numpy arrays.  The three planes are views
    of one ``[3, n_rows, 128]`` tensor, so one L2 access-policy window
    covers them all (:func:`.probe_cuda.probe_rows_resident`).
    """
    if isinstance(table, Sequence):
        arrays = table
    else:
        arrays = (table.key_left, table.key_right, table.values)
    stacked = np.stack([np.asarray(a, dtype=np.int32).reshape(-1, LANES) for a in arrays])
    buf = torch.from_numpy(stacked).to(device)
    return buf[0], buf[1], buf[2]


def bigtable_device_table(table, device) -> torch.Tensor:
    """The table as ``[4, n_rows, 384]`` int8 byte planes.

    Bit-equal to ``tokenizer_tpu.ops.exp_pallas_bigtable.bigtable_device_table``:
    row r holds slots ``[128 r, 128 (r + 1))`` with key_left in lanes
    0-127, key_right in 128-255 and values in 256-383, and plane k holds
    byte k (little end first) of each int32 entry.
    """
    n_rows = table.n_slots // LANES
    if n_rows * LANES != table.n_slots:
        raise ValueError(f"{table.n_slots} slots is not a whole number of {LANES}-slot rows")
    t32 = np.concatenate(
        [np.asarray(a, dtype=np.int32).reshape(n_rows, LANES)
         for a in (table.key_left, table.key_right, table.values)],
        axis=1,
    )
    planes = np.stack([((t32 >> (8 * k)) & 0xFF).astype(np.uint8) for k in range(4)])
    return torch.from_numpy(planes.view(np.int8)).to(device)


def probe_rows_torch(
    planes: Union[Planes, Sequence[torch.Tensor]],
    slot_bits: int,
    max_probes: int,
    left: torch.Tensor,
    right: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K3 and K4: the lookup through ``[n_rows, 128]`` planes.

    For each probe round, each pair reads ``plane[slot >> 7, slot & 127]``
    of the three planes, as ``_dma_kernel`` and ``_vmem_kernel`` read a
    row and select its lane.  Any shape, int32 in and out.
    """
    kl_p, kr_p, vv_p = planes
    slot, live = hash_slots(left, right, slot_bits)
    mask = (1 << slot_bits) - 1
    out = torch.full(left.shape, MAX_RANK, dtype=torch.int32, device=left.device)
    for _ in range(max_probes):
        row, lane = slot // LANES, slot % LANES
        kl, kr = kl_p[row, lane], kr_p[row, lane]
        hit = live & (kl == left) & (kr == right)
        out = torch.where(hit, vv_p[row, lane], out)
        live = live & (kl != -1) & ~hit
        slot = (slot + 1) & mask
    return out


def lookup_onehot_torch(
    tab8: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> torch.Tensor:
    """Plain version of K5: each row fetched by a one-hot matrix product.

    ``tab8`` is :func:`bigtable_device_table`'s ``[4, n_rows, 384]`` int8;
    ``left``/``right`` are ``[S, 128]`` int32.  Per probe round,
    ``one_hot(row) [S*128, n_rows] @ tab8[k]`` for each byte plane k, in
    float32 with ``torch.matmul``.  That is exact: each output sums one
    nonzero term, a byte in [-128, 127], which even TF32 holds.  The bytes
    are masked to 0..255, put back together as the int32 bit pattern
    (so the -1 keys come back as -1), and the pair's lane is selected.
    """
    n_rows = tab8.shape[1]
    planes = tab8.to(torch.float32)
    slot, live = hash_slots(left, right, slot_bits)
    mask = (1 << slot_bits) - 1
    cols = torch.arange(n_rows, device=left.device)
    out = torch.full(left.shape, MAX_RANK, dtype=torch.int32, device=left.device)
    for _ in range(max_probes):
        row = (slot // LANES).reshape(-1, 1)
        lane = (slot % LANES).reshape(-1, 1)
        onehot = (cols[None, :] == row).to(torch.float32)  # [S*128, n_rows]
        word = torch.zeros(row.shape[0], 3 * LANES, dtype=torch.int64, device=left.device)
        for k in range(4):
            byte = torch.matmul(onehot, planes[k]).to(torch.int64) & 0xFF
            word |= byte << (8 * k)
        word = torch.where(word >= 2**31, word - 2**32, word)  # uint32 -> int32
        kl, kr, vv = (
            torch.gather(word[:, g * LANES : (g + 1) * LANES], 1, lane)
            .reshape(left.shape)
            .to(torch.int32)
            for g in range(3)
        )
        hit = live & (kl == left) & (kr == right)
        out = torch.where(hit, vv, out)
        live = live & (kl != -1) & ~hit
        slot = (slot + 1) & mask
    return out
