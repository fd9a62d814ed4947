"""Wrappers of the hand-written CUDA probe kernels (K3, K4, K5).

Each keeps the JAX package's layout and computes ``PairTable.lookup``:

* :func:`probe_rows_async`: K3, ``csrc/probe_rows.cu`` ``tt_probe_rows_async``,
  counterpart of ``tokenizer_tpu.ops.exp_pallas_dma.probe_pallas_dma``;
* :func:`probe_rows_resident`: K4, ``tt_probe_rows_resident``, counterpart
  of ``probe_pallas_vmem``; :func:`probe_windows` is the window of slots
  each pass of either kernel reads per pair;
* :func:`lookup_onehot`: K5, ``csrc/lookup_onehot.cu`` ``tt_lookup_onehot``,
  counterpart of ``tokenizer_tpu.ops.exp_pallas_bigtable.lookup_onehot_pallas``;
  :func:`onehot_tiling` is the tiling its kernel walks.

A CPU tensor runs the plain PyTorch version (:mod:`.exp_probe_torch`); a
CUDA tensor launches the kernel on the current stream or raises.  Each
wrapper counts its launches in a module integer, so a run can show that
its path went through the kernel.  :func:`persisting_l2` reserves the L2
set-aside that K4's access-policy window draws on, and gives it back.
"""

from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .exp_probe_torch import LANES, lookup_onehot_torch, probe_rows_torch
from .merge_cuda import _check_int32, _raise_on
from .pair_table import hash_pair_u32

__all__ = [
    "ASYNC_LAUNCHES",
    "ONEHOT_LAUNCHES",
    "OnehotTiling",
    "PASS_BYTES",
    "PASS_ROUNDS",
    "ProbeWindows",
    "RESIDENT_LAUNCHES",
    "WINDOW_SLOTS",
    "check_kmajor",
    "l2_limits",
    "lookup_onehot",
    "onehot_tiling",
    "pair_homes",
    "persisting_l2",
    "probe_rows_async",
    "probe_rows_resident",
    "probe_windows",
]

#: Launches of K3 / K4 / K5 in this process.
ASYNC_LAUNCHES = 0
RESIDENT_LAUNCHES = 0
ONEHOT_LAUNCHES = 0

_ALIGN = 16  # cp.async.bulk, int4 and TMA 16-byte operands


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

    The counterpart of ``probe_pallas_dma``: each pair's window of every
    plane (:func:`probe_windows`) is copied into shared memory by the bulk
    asynchronous copy unit, 32 pairs completing on one mbarrier, so a pair
    waits for one round trip per pass, and the pair's rounds are read
    there in order.  Any shape of int32 pairs; ``planes`` as
    :func:`.exp_probe_torch.table_planes_2d` makes them.
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
    end of the highest, so the one buffer of ``table_planes_2d``); a
    half-warp serves a pair, each lane loading one round's slot of the
    three planes before any compare, and a warp ballot picks the first
    round that is empty or a hit.  The window draws on the set-aside that
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


#: Probe rounds one pass of K3 or K4 covers.  ``PairTable.build`` keeps
#: max_probes <= 16 below 2^26 slots, so one pass serves every table it makes.
PASS_ROUNDS = 16
#: Slots of one plane that a pass of K3 copies for a pair: 16 rounds from any
#: slot, the start rounded down and the end up to 16 bytes (4 slots).
WINDOW_SLOTS = PASS_ROUNDS + 4
#: Bytes one pass can hold per pair: its window of the three int32 planes.
PASS_BYTES = 3 * 4 * WINDOW_SLOTS


@dataclass(frozen=True)
class ProbeWindows:
    """The slots K3 copies, and K4 loads, for each pair of a call.

    Pass ``k`` of pair ``i`` covers rounds ``16 k .. 16 k + 15`` (the last
    pass fewer) of the chain from ``homes[i]``; a pair whose chain ended in
    an earlier pass takes no later one.  :meth:`spans` gives each pass's one
    or two slot spans, the second from slot 0 when the chain wraps past the
    last slot; ``csrc/probe_rows.cu`` ``pass_window`` does the same
    arithmetic.  A pair with a negative id (``homes == -1``) reads nothing.
    """

    homes: np.ndarray  # int64 [n]
    max_probes: int
    slot_bits: int

    @property
    def passes(self) -> int:
        return -(-self.max_probes // PASS_ROUNDS)

    def rounds(self, k: int) -> int:
        """Rounds pass ``k`` covers."""
        return min(PASS_ROUNDS, self.max_probes - k * PASS_ROUNDS)

    def spans(self, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pass ``k``'s ``(starts [n, 2], lengths [n, 2], offsets [n])`` in
        slots: the spans ``[start, start + length)``, multiples of 4 slots
        (16 bytes), and where round ``16 k`` of each pair sits in its two
        spans laid end to end (round ``16 k + j`` at ``offset + j``).
        Pairs with a negative id get lengths 0."""
        n, homes = 1 << self.slot_bits, self.homes
        s0 = (homes + k * PASS_ROUNDS) & (n - 1)
        start = s0 & ~3
        end = s0 + self.rounds(k)  # one past the last slot, unwrapped
        wrap = end > n
        len1 = np.where(wrap, n - start, (end + 3) // 4 * 4 - start)
        len2 = np.where(wrap, (end - n + 3) // 4 * 4, 0)
        valid = homes >= 0
        starts = np.stack([np.where(valid, start, 0), np.zeros_like(start)], axis=-1)
        lengths = np.stack([np.where(valid, len1, 0), np.where(valid, len2, 0)], axis=-1)
        return starts, lengths, np.where(valid, s0 - start, 0)

    @property
    def bytes(self) -> int:
        """Bytes of the three planes that every pass's spans hold, summed
        over the pairs: what a call copies when every chain runs all its
        passes, and exactly what it copies when ``max_probes <= 16``."""
        return sum(3 * 4 * int(self.spans(k)[1].sum()) for k in range(self.passes))


def probe_windows(homes, max_probes: int, slot_bits: int) -> ProbeWindows:
    """K3's and K4's windows for pairs whose home slots are ``homes`` (any
    shape, flattened; -1 for a pair with a negative id)."""
    if max_probes < 1 or not 7 <= slot_bits <= 31:
        raise ValueError(f"max_probes {max_probes}, slot_bits {slot_bits}: need >= 1 and 7..31")
    homes = np.asarray(homes, np.int64).reshape(-1)
    if homes.size and (homes.min() < -1 or homes.max() >= 1 << slot_bits):
        raise ValueError(f"homes must be -1 or slots below 2^{slot_bits}")
    return ProbeWindows(homes, max_probes, slot_bits)


def pair_homes(left, right, slot_bits: int) -> np.ndarray:
    """Home slot of each (left, right) pair, -1 where an id is negative."""
    left, right = np.asarray(left, np.int32), np.asarray(right, np.int32)
    valid = (left >= 0) & (right >= 0)
    return np.where(valid, hash_pair_u32(left, right, slot_bits), -1).astype(np.int64).reshape(-1)


#: K5's tiles (``csrc/lookup_onehot.cu``): pair-round rows, columns (one
#: array of one byte plane) and bytes of K per pipeline stage.
ONEHOT_TILE_M = 256
ONEHOT_TILE_N = LANES
ONEHOT_TILE_K = 128
#: Columns of K5's product: 4 byte planes of key_left, key_right and values.
ONEHOT_N = 4 * 3 * LANES


@dataclass(frozen=True)
class OnehotTiling:
    """How K5's kernel cuts its product ``C[M, N] = one_hot[M, K] @ B[K, N]``.

    Row ``m`` of C is pair ``m % (S * 128)`` at round ``m // (S * 128)``;
    column ``n`` is lane ``n % 128`` of array ``(n // 128) % 3`` (key_left,
    key_right, values) in byte plane ``n // 384``; K is the table's rows.
    M is padded up to whole M-tiles.  Tile ``t`` is M-tile ``t % m_tiles``
    of N-tile ``t // m_tiles``, and persistent CTA ``b`` of ``grid`` takes
    tiles ``b, b + grid, ...``, so the CTAs in flight share an N-tile of B.
    """

    S: int
    max_probes: int
    n_rows: int

    n_tiles = ONEHOT_N // ONEHOT_TILE_N

    @property
    def n_pairs(self) -> int:
        return self.S * LANES

    @property
    def m_rows(self) -> int:
        return self.n_pairs * self.max_probes

    @property
    def m_tiles(self) -> int:
        return -(-self.m_rows // ONEHOT_TILE_M)

    @property
    def k_tiles(self) -> int:
        return self.n_rows // ONEHOT_TILE_K

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def scratch_shape(self) -> Tuple[int, int, int]:
        """The int32 words the epilogue writes byte by byte: [array, round, pair]."""
        return (3, self.max_probes, self.n_pairs)

    @property
    def l2_to_smem_bytes(self) -> int:
        """Bytes of B that TMA copies into shared memory per call: every
        tile streams its N-tile over all of K."""
        return self.tiles * ONEHOT_TILE_N * self.n_rows

    def grid(self, sm_count: int) -> int:
        """Persistent CTAs: one per SM, or one per tile when there are fewer."""
        return max(1, min(self.tiles, sm_count))

    def tile(self, t: int) -> Tuple[int, int]:
        """``(m_tile, n_tile)`` of tile ``t``."""
        return t % self.m_tiles, t // self.m_tiles

    def cta_tiles(self, cta: int, grid: int) -> range:
        return range(cta, self.tiles, grid)

    def rows(self, m_tile: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(round, pair)`` of the M-tile's rows below ``m_rows``; the
        padded rows after them get no one-hot and are never written."""
        m = np.arange(m_tile * ONEHOT_TILE_M, min((m_tile + 1) * ONEHOT_TILE_M, self.m_rows))
        return m // self.n_pairs, m % self.n_pairs

    def written_bytes(self, t: int) -> np.ndarray:
        """Flat byte offsets into the scratch that tile ``t``'s epilogue
        writes: byte ``plane`` of word ``[array, round, pair]`` per row."""
        m_tile, n_tile = self.tile(t)
        plane, array = divmod(n_tile, 3)
        rnd, pair = self.rows(m_tile)
        return ((array * self.max_probes + rnd) * self.n_pairs + pair) * 4 + plane


def onehot_tiling(S: int, max_probes: int, n_rows: int) -> OnehotTiling:
    """K5's tiling of an ``[S, 128]`` tile against a table of ``n_rows`` rows."""
    if S < 1 or max_probes < 1 or n_rows < 1:
        raise ValueError(f"S {S}, max_probes {max_probes}, n_rows {n_rows}: need all >= 1")
    return OnehotTiling(S, max_probes, n_rows)


def check_kmajor(tab_k: torch.Tensor, slot_bits: int, device) -> int:
    """Check K5's prepared table (:func:`.exp_probe_torch.bigtable_kmajor`)
    for the kernel: int8, on ``device``, ``[1536, n_rows]``, contiguous,
    16-byte aligned (TMA's rule), with ``n_rows * 128 == 2**slot_bits`` and
    ``n_rows`` a multiple of 128 (whole K-tiles).  Returns ``n_rows``."""
    if not isinstance(tab_k, torch.Tensor) or tab_k.dtype != torch.int8:
        raise TypeError(f"tab_k must be an int8 tensor, got {getattr(tab_k, 'dtype', type(tab_k))}")
    if tab_k.device != torch.device(device):
        raise ValueError(f"tab_k is on {tab_k.device}, expected {device}")
    if tab_k.dim() != 2 or tab_k.shape[0] != ONEHOT_N:
        raise ValueError(f"tab_k must be [{ONEHOT_N}, n_rows] (bigtable_kmajor), got {tuple(tab_k.shape)}")
    n_rows = tab_k.shape[1]
    if n_rows % ONEHOT_TILE_K or n_rows * LANES != 1 << slot_bits:
        raise ValueError(
            f"n_rows {n_rows}: need a multiple of {ONEHOT_TILE_K} with n_rows * {LANES} == 2^{slot_bits}"
        )
    if not tab_k.is_contiguous():
        raise ValueError("tab_k must be contiguous")
    if tab_k.data_ptr() % _ALIGN:
        raise ValueError(f"tab_k must be {_ALIGN}-byte aligned")
    return n_rows


def _check_jax_layout(tab8: torch.Tensor, slot_bits: int, device) -> None:
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


def lookup_onehot(
    tab: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    *,
    slot_bits: int,
    max_probes: int,
) -> torch.Tensor:
    """K5: the lookup of an ``[S, 128]`` tile by one-hot int8 matrix products.

    The counterpart of ``lookup_onehot_pallas``.  On the CPU, ``tab`` is the
    JAX layout, :func:`.exp_probe_torch.bigtable_device_table`'s
    ``[4, n_rows, 384]`` int8, and the plain version runs.  On the card it
    is that table made K-major once by
    :func:`.exp_probe_torch.bigtable_kmajor`, ``[1536, n_rows]``
    (:func:`check_kmajor`), and one launch computes every round's product
    with ``wgmma`` s8 fed by TMA, tiled as :func:`onehot_tiling` says,
    then resolves the rounds.  The wrapper allocates the
    ``[3, max_probes, S * 128]`` int32 scratch the two kernels pass the
    selected words through.
    """
    global ONEHOT_LAUNCHES
    device = _check_pairs(left, right)
    if left.dim() != 2 or left.shape[1] != LANES:
        raise ValueError(f"left/right must be [S, {LANES}], got {tuple(left.shape)}")
    if device.type == "cpu":
        _check_jax_layout(tab, slot_bits, device)
        return lookup_onehot_torch(tab, left, right, slot_bits=slot_bits, max_probes=max_probes)
    n_rows = check_kmajor(tab, slot_bits, device)
    out = torch.empty_like(left)
    S = left.shape[0]
    if S == 0:
        return out
    from ..runtime.build import load_library

    lib = load_library()
    tiling = onehot_tiling(S, max_probes, n_rows)
    grid = tiling.grid(torch.cuda.get_device_properties(device).multi_processor_count)
    scratch = torch.empty(tiling.scratch_shape, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = lib.tt_lookup_onehot(
            tab.data_ptr(),
            n_rows,
            slot_bits,
            max_probes,
            left.data_ptr(),
            right.data_ptr(),
            out.data_ptr(),
            scratch.data_ptr(),
            S,
            tiling.m_tiles,
            grid,
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
