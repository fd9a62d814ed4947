"""Wrappers of the hand-written CUDA merge kernels (``csrc/merge_packed.cu``).

:func:`merge_packed` keeps the JAX package's layout: an ``[L, B]`` int32
tile and ``[B]`` lengths in, ``(out_ids [L, B], out_n [B])`` out.  A CPU
tensor runs the plain PyTorch version (:mod:`.merge_torch`); a CUDA tensor
launches the kernel on the current stream or raises.  ``LAUNCHES`` counts
kernel launches so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .merge_torch import lookup_pairs_torch, merge_packed_torch

__all__ = [
    "merge_packed",
    "merge_packed_v1",
    "lookup_pairs",
    "LAUNCHES",
    "V1_LAUNCHES",
    "LOOKUP_LAUNCHES",
    "LANE",
    "MAX_L",
]

#: The B quantum of a tile: the first kernel's columns per block, and
#: the packer's lane quantum (ops/packing.py LANE), which makes every B a
#: multiple of it.
LANE = 128
#: The largest L of :func:`merge_packed` (``kMaxL`` in
#: ``csrc/merge_packed.cu``).
MAX_L = 2048

#: Launches of the merge kernel, of the first merge kernel and of the
#: probe kernel in this process.
LAUNCHES = 0
V1_LAUNCHES = 0
LOOKUP_LAUNCHES = 0

_TAB_KEYS = ("key_left", "key_right", "values")


def _check_int32(name: str, t: torch.Tensor, ndim: int, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tab(tab: Dict[str, torch.Tensor], device: torch.device) -> None:
    n_slots = tab["key_left"].numel()
    for k in _TAB_KEYS:
        _check_int32(f"tab[{k!r}]", tab[k], 1, device)
        if tab[k].numel() != n_slots:
            raise ValueError("pair-table arrays differ in length")


def _tab_ptrs(tab: Dict[str, torch.Tensor]):
    return tuple(tab[k].data_ptr() for k in _TAB_KEYS)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.tt_error_string(rc).decode()} ({rc})")


def _check_tile(tab, ids: torch.Tensor, lengths: torch.Tensor) -> Tuple[int, int]:
    device = ids.device
    _check_int32("ids", ids, 2, device)
    L, B = ids.shape
    _check_int32("lengths", lengths, 1, device)
    if lengths.shape[0] != B:
        raise ValueError(f"lengths has {lengths.shape[0]} entries for {B} columns")
    if L < 1 or B < 1 or B % LANE:
        raise ValueError(f"tile [{L}, {B}]: need L >= 1 and B a positive multiple of {LANE}")
    _check_tab(tab, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_packed runs on cpu or cuda tensors, not {device}")
    return L, B


def merge_packed(
    tab: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a packed [L, B] tile; returns (out_ids [L, B], out_n [B]).

    On a CUDA tensor, one launch of the warp-per-column kernel; ``L`` may
    be at most :data:`MAX_L` (its columns live in shared memory).
    Preconditions, which :func:`tokenizer_tpu_torch.ops.packing.pack_spans`
    meets: ``0 <= lengths <= L`` and every row at or beyond a column's
    length holds -1.  The kernel never shifts those rows, so the full
    output tile equals ``merge_packed_jax``'s only under that padding.
    """
    global LAUNCHES
    L, B = _check_tile(tab, ids, lengths)
    if L > MAX_L:
        raise ValueError(
            f"tile [{L}, {B}]: L may be at most MAX_L = {MAX_L} (the merge kernel "
            "keeps each column in shared memory)"
        )
    if ids.device.type == "cpu":
        return merge_packed_torch(
            tab, ids, lengths, slot_bits=slot_bits, max_probes=max_probes
        )
    from ..runtime.build import load_library

    lib = load_library()
    out_ids = torch.empty_like(ids)
    out_n = torch.empty_like(lengths)
    with torch.cuda.device(ids.device):
        rc = lib.tt_merge_packed(
            *_tab_ptrs(tab),
            slot_bits,
            max_probes,
            ids.data_ptr(),
            lengths.data_ptr(),
            out_ids.data_ptr(),
            out_n.data_ptr(),
            L,
            B,
            torch.cuda.current_stream(ids.device).cuda_stream,
        )
    _raise_on(lib, rc, "merge_packed")
    LAUNCHES += 1
    return out_ids, out_n


def merge_packed_v1(
    tab: Dict[str, torch.Tensor],
    ids: torch.Tensor,
    lengths: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`merge_packed` through the port's first kernel (one thread per
    column, ranks in an ``[L, B]`` global scratch), kept so that the two
    kernels can be timed within one process.  Nothing on the main path
    calls it.  Any ``L >= 1``."""
    global V1_LAUNCHES
    L, B = _check_tile(tab, ids, lengths)
    if ids.device.type == "cpu":
        return merge_packed_torch(
            tab, ids, lengths, slot_bits=slot_bits, max_probes=max_probes
        )
    from ..runtime.build import load_library

    lib = load_library()
    out_ids = torch.empty_like(ids)
    out_n = torch.empty_like(lengths)
    rank = torch.empty_like(ids)
    with torch.cuda.device(ids.device):
        rc = lib.tt_merge_packed_v1(
            *_tab_ptrs(tab),
            slot_bits,
            max_probes,
            ids.data_ptr(),
            lengths.data_ptr(),
            out_ids.data_ptr(),
            out_n.data_ptr(),
            rank.data_ptr(),
            L,
            B,
            torch.cuda.current_stream(ids.device).cuda_stream,
        )
    _raise_on(lib, rc, "merge_packed_v1")
    V1_LAUNCHES += 1
    return out_ids, out_n


def lookup_pairs(
    tab: Dict[str, torch.Tensor],
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> torch.Tensor:
    """(left, right) -> merged id, MAX_RANK on a miss; 1-D int32 tensors.

    The merge kernel's own ``probe()``, launched alone so that the hash
    and probe sequence can be checked against ``PairTable.lookup``.
    """
    global LOOKUP_LAUNCHES
    device = left.device
    _check_int32("left", left, 1, device)
    _check_int32("right", right, 1, device)
    if right.shape != left.shape:
        raise ValueError("left and right differ in shape")
    _check_tab(tab, device)
    if device.type == "cpu":
        return lookup_pairs_torch(tab, slot_bits, max_probes, left, right)
    if device.type != "cuda":
        raise ValueError(f"lookup_pairs runs on cpu or cuda tensors, not {device}")
    out = torch.empty_like(left)
    if left.numel() == 0:
        return out
    from ..runtime.build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.tt_lookup_pairs(
            *_tab_ptrs(tab),
            slot_bits,
            max_probes,
            left.data_ptr(),
            right.data_ptr(),
            out.data_ptr(),
            left.numel(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, rc, "lookup_pairs")
    LOOKUP_LAUNCHES += 1
    return out
