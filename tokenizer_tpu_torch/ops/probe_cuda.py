"""Wrappers of the hand-written CUDA probe kernels (K3, K4, K5).

Each keeps the JAX package's layout and computes ``PairTable.lookup``:

* :func:`probe_rows_async`: K3, ``csrc/probe_rows.cu`` ``tt_probe_rows_async``,
  counterpart of ``tokenizer_tpu.ops.exp_pallas_dma.probe_pallas_dma``;
* :func:`probe_rows_resident`: K4, ``tt_probe_rows_resident``, counterpart
  of ``probe_pallas_vmem``;
* :func:`lookup_onehot`: K5, ``csrc/lookup_onehot.cu`` ``tt_lookup_onehot``,
  counterpart of ``tokenizer_tpu.ops.exp_pallas_bigtable.lookup_onehot_pallas``.

A CPU tensor runs the plain PyTorch version (:mod:`.exp_probe_torch`); a
CUDA tensor launches the kernel on the current stream or raises.  Each
wrapper counts its launches in a module integer, so a run can show that
its path went through the kernel.  :func:`persisting_l2` reserves the L2
set-aside that K4's access-policy window draws on, and gives it back.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Sequence

import torch

from .exp_probe_torch import LANES, lookup_onehot_torch, probe_rows_torch
from .merge_cuda import _check_int32, _raise_on

__all__ = [
    "ASYNC_LAUNCHES",
    "ONEHOT_LAUNCHES",
    "RESIDENT_LAUNCHES",
    "l2_limits",
    "lookup_onehot",
    "persisting_l2",
    "probe_rows_async",
    "probe_rows_resident",
]

#: Launches of K3 / K4 / K5 in this process.
ASYNC_LAUNCHES = 0
RESIDENT_LAUNCHES = 0
ONEHOT_LAUNCHES = 0

_ALIGN = 16  # cp.async.bulk, int4 and cp.async 16-byte operands


def _check_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.device:
    device = left.device
    _check_int32("left", left, left.dim(), device)
    _check_int32("right", right, left.dim(), device)
    if right.shape != left.shape:
        raise ValueError("left and right differ in shape")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"probe kernels run on cpu or cuda tensors, not {device}")
    return device


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.device.type == "cuda" and t.data_ptr() % _ALIGN:
        raise ValueError(f"{name} must be {_ALIGN}-byte aligned")


def _check_planes(planes: Sequence[torch.Tensor], slot_bits: int, device) -> None:
    if len(planes) != 3:
        raise ValueError(f"need 3 planes (key_left, key_right, values), got {len(planes)}")
    for k, p in zip(("key_left", "key_right", "values"), planes):
        _check_int32(f"planes[{k!r}]", p, 2, device)
        if p.shape[1] != LANES or p.shape[0] * LANES != 1 << slot_bits:
            raise ValueError(
                f"plane {k} has shape {tuple(p.shape)}; need [2^{slot_bits} / {LANES}, {LANES}]"
            )
        _check_aligned(f"plane {k}", p)


def _launch_rows(fn_name: str, planes, left, right, slot_bits, max_probes, *extra):
    from ..runtime.build import load_library

    lib = load_library()
    out = torch.empty_like(left)
    device = left.device
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(
            planes[0].data_ptr(),
            planes[1].data_ptr(),
            planes[2].data_ptr(),
            slot_bits,
            max_probes,
            left.data_ptr(),
            right.data_ptr(),
            out.data_ptr(),
            left.numel(),
            *extra,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, rc, fn_name)
    return out


def probe_rows_async(
    planes: Sequence[torch.Tensor],
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> torch.Tensor:
    """K3: (left, right) -> merged id through ``[n_rows, 128]`` planes.

    The counterpart of ``probe_pallas_dma``: per probe round, each pair's
    three rows are copied into shared memory by the bulk asynchronous copy
    unit, completing on an mbarrier, and the lane is read there.  Any
    shape of int32 pairs; ``planes`` as :func:`.exp_probe_torch.table_planes_2d`
    makes them.
    """
    global ASYNC_LAUNCHES
    device = _check_pairs(left, right)
    _check_planes(planes, slot_bits, device)
    if device.type == "cpu":
        return probe_rows_torch(planes, slot_bits, max_probes, left, right)
    if left.numel() == 0:
        return torch.empty_like(left)
    out = _launch_rows("tt_probe_rows_async", planes, left, right, slot_bits, max_probes)
    ASYNC_LAUNCHES += 1
    return out


def probe_rows_resident(
    planes: Sequence[torch.Tensor],
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> torch.Tensor:
    """K4: the same lookup with the planes held in L2.

    The counterpart of ``probe_pallas_vmem``: the launch marks the planes
    persisting with an access-policy window (from the lowest plane to the
    end of the highest, so the one buffer of ``table_planes_2d``), each
    row is one coalesced int4 load per lane and the lane is resolved by a
    warp shuffle.  The window draws on the set-aside that
    :func:`persisting_l2` reserves; without one it changes nothing.
    """
    global RESIDENT_LAUNCHES
    device = _check_pairs(left, right)
    _check_planes(planes, slot_bits, device)
    if device.type == "cpu":
        return probe_rows_torch(planes, slot_bits, max_probes, left, right)
    if left.numel() == 0:
        return torch.empty_like(left)
    lo = min(p.data_ptr() for p in planes)
    hi = max(p.data_ptr() + p.numel() * p.element_size() for p in planes)
    out = _launch_rows(
        "tt_probe_rows_resident", planes, left, right, slot_bits, max_probes, lo, hi - lo
    )
    RESIDENT_LAUNCHES += 1
    return out


def lookup_onehot(
    tab8: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> torch.Tensor:
    """K5: the lookup of an ``[S, 128]`` tile by one-hot int8 matrix products.

    The counterpart of ``lookup_onehot_pallas``, on int8 tensor cores
    (``mma.sync`` m16n8k32 s8).  ``tab8`` is the ``[4, n_rows, 384]`` int8
    byte planes of :func:`.exp_probe_torch.bigtable_device_table`, with
    ``n_rows * 128 == 2**slot_bits`` and ``n_rows`` a multiple of 32.  On
    the card the wrapper transposes it to ``[4, 384, n_rows]`` for each
    call (one 6-13 MB copy) and allocates the ``[3, max_probes, S * 128]``
    int32 scratch the two kernels pass the selected words through.
    """
    global ONEHOT_LAUNCHES
    device = _check_pairs(left, right)
    if left.dim() != 2 or left.shape[1] != LANES:
        raise ValueError(f"left/right must be [S, {LANES}], got {tuple(left.shape)}")
    if not isinstance(tab8, torch.Tensor) or tab8.dtype != torch.int8:
        raise TypeError(f"tab8 must be an int8 tensor, got {getattr(tab8, 'dtype', type(tab8))}")
    if tab8.device != device:
        raise ValueError(f"tab8 is on {tab8.device}, expected {device}")
    if tab8.dim() != 3 or tab8.shape[0] != 4 or tab8.shape[2] != 3 * LANES:
        raise ValueError(f"tab8 must be [4, n_rows, {3 * LANES}], got {tuple(tab8.shape)}")
    n_rows = tab8.shape[1]
    if n_rows % 32 or n_rows * LANES != 1 << slot_bits:
        raise ValueError(
            f"n_rows {n_rows}: need a multiple of 32 with n_rows * {LANES} == 2^{slot_bits}"
        )
    if device.type == "cpu":
        return lookup_onehot_torch(tab8, left, right, slot_bits=slot_bits, max_probes=max_probes)
    out = torch.empty_like(left)
    S = left.shape[0]
    if S == 0:
        return out
    from ..runtime.build import load_library

    lib = load_library()
    tab_t = tab8.transpose(1, 2).contiguous()
    _check_aligned("tab8", tab_t)
    scratch = torch.empty((3, max_probes, S * LANES), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.tt_lookup_onehot(
            tab_t.data_ptr(),
            n_rows,
            slot_bits,
            max_probes,
            left.data_ptr(),
            right.data_ptr(),
            out.data_ptr(),
            scratch.data_ptr(),
            S,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, rc, "lookup_onehot")
    ONEHOT_LAUNCHES += 1
    return out


def l2_limits(device) -> Dict[str, int]:
    """The card's largest persisting-L2 set-aside and access-policy window,
    and the set-aside reserved now, in bytes."""
    from ..runtime.build import load_library

    lib = load_library()
    persist, window, now = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_size_t(0)
    with torch.cuda.device(device):
        rc = lib.tt_l2_persist_attrs(
            ctypes.addressof(persist), ctypes.addressof(window), ctypes.addressof(now)
        )
    _raise_on(lib, rc, "l2_limits")
    return {
        "max_persisting_l2_bytes": persist.value,
        "max_access_policy_window_bytes": window.value,
        "persisting_l2_bytes": now.value,
    }


@contextlib.contextmanager
def persisting_l2(nbytes: int, device) -> Iterator[None]:
    """Reserve ``nbytes`` of L2 (capped at the card's maximum) for persisting
    accesses, such as K4's window; on exit demote every persisting line to
    normal and put the previous set-aside back.

    The set-aside is device-wide: while it holds, it applies to every
    kernel on the card.  A card need not start at 0 (an H100 80GB HBM3
    started at 9,830,400 bytes, 30% of its maximum).
    """
    from ..runtime.build import load_library

    lib = load_library()
    before = l2_limits(device)["persisting_l2_bytes"]
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        _raise_on(lib, lib.tt_l2_persist_set(nbytes), "persisting_l2 set-up")
    try:
        yield
    finally:
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            _raise_on(lib, lib.tt_l2_persist_reset(), "persisting_l2 reset")
            _raise_on(lib, lib.tt_l2_persist_set(before), "persisting_l2 restore")
