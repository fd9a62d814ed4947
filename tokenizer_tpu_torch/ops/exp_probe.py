"""The arms of the pair-table probe experiment, on one device.

Counterpart of the JAX package's runners ``tools/exp_pallas_dma.py`` (K3,
K4) and ``tools/exp_pallas_bigtable.py`` (K5): a tile of pairs, half of
them keys of the table, probes a real pair table through each hand-written
formulation and through the production probe, and each arm is held to
``PairTable.lookup`` bit for bit.  On the card every arm times its kernel
and its plain PyTorch version with CUDA events; on the CPU only the plain
versions run, and nothing is timed.  ``tools/exp_cuda_probe.py`` is the
command-line entry.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import merge_cuda, probe_cuda
from .exp_probe_torch import (
    bigtable_device_table,
    bigtable_kmajor,
    lookup_onehot_torch,
    probe_rows_torch,
    table_planes_2d,
)
from .merge_torch import device_table, hash_slots, lookup_pairs_torch

__all__ = [
    "ARMS",
    "BIG_SHAPE",
    "ROW_ARMS",
    "SHAPE",
    "arm_calls",
    "device_us",
    "l2_for",
    "make_probes",
    "median_ms",
    "onehot_product",
    "queued_ms",
    "run_arms",
]

#: One merge wave's worth of probes (2,048), the JAX runners' tile.
SHAPE = (16, 128)
#: 131,072 pairs, as many as 16 rows of the packer's widest tile (8,192
#: columns): large enough that a probe kernel's time is its work, not its
#: launch.  K5 is not run there (its plain version's one-hot would take
#: up to 8.6 GB).
BIG_SHAPE = (1024, 128)
#: The arms that run at BIG_SHAPE.
ROW_ARMS = ("lookup_pairs", "probe_rows_async", "probe_rows_resident")
REPS = 5

#: Device-side rows that are the profiler's own bookkeeping.
_PROFILER_ROWS = ("Activity Buffer Request",)

#: (arm, kernel source, TPU function it stands for)
ARMS = (
    ("lookup_pairs", "tokenizer_tpu_torch/csrc/merge_packed.cu",
     "tokenizer_tpu/ops/merge_jax.py:49"),
    ("probe_rows_async", "tokenizer_tpu_torch/csrc/probe_rows.cu",
     "tokenizer_tpu/ops/exp_pallas_dma.py:277"),
    ("probe_rows_resident", "tokenizer_tpu_torch/csrc/probe_rows.cu",
     "tokenizer_tpu/ops/exp_pallas_dma.py:188"),
    ("lookup_onehot", "tokenizer_tpu_torch/csrc/lookup_onehot.cu",
     "tokenizer_tpu/ops/exp_pallas_bigtable.py:185"),
)


def make_probes(table, shape=SHAPE, seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """int32 ``(left, right)`` of ``shape``: the first half keys of the
    table (hits), the rest random ids below ``n_vocab`` (mostly misses),
    and every 37th pair's left id set to -1 (invalid), as the JAX runner
    and its test build them."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    filled = np.nonzero(table.key_left != -1)[0]
    pick = rng.choice(filled, size=n // 2)
    left = np.empty(n, np.int32)
    right = np.empty(n, np.int32)
    left[: n // 2] = table.key_left[pick]
    right[: n // 2] = table.key_right[pick]
    left[n // 2 :] = rng.integers(0, table.n_vocab, n - n // 2)
    right[n // 2 :] = rng.integers(0, table.n_vocab, n - n // 2)
    left[::37] = -1
    return left.reshape(shape), right.reshape(shape)


def median_ms(fn: Callable[[], object], reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def queued_ms(fn: Callable[[], object], reps: int = REPS) -> float:
    """Device ms per ``fn()`` call, without the host's enqueue time.

    ``reps`` calls are queued behind a sleep kernel that outlasts their
    enqueue, and CUDA events time them back to back; the result is that
    time over ``reps``.  ``fn`` must not wait for the device.  Unlike the
    profiler's rows (:func:`device_us`), nothing here can be dropped.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Twice the enqueue time at 2 GHz (the SM clock is at most 1.98 GHz),
    # plus 1 ms, so that the sleep ends after the last call is queued.
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn: Callable[[], object], reps: int = REPS) -> Optional[float]:
    """Device time of one ``fn()`` call in µs: the card's own profiler rows
    (kernels, copies, fills) over ``reps`` calls after a warm-up, summed and
    divided by ``reps``.  Host enqueue time is not in it.  None if the
    profiler saw no device row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [
        e.time_range.end - e.time_range.start
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.name not in _PROFILER_ROWS
    ]
    return sum(spans) / reps if spans else None


def arm_calls(table, device) -> Dict[str, Tuple[Callable, Callable]]:
    """Per arm, ``(kernel(left, right), plain(left, right))`` over the
    table's layouts on ``device``; pairs are ``[S, 128]`` int32 tensors.
    Every layout is made here, once, outside the calls: on the card K5's
    kernel takes the planes K-major (``bigtable_kmajor``), the CPU route
    the JAX layout."""
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    sb, mp = table.slot_bits, table.max_probes
    tab = device_table(table, device)
    planes = table_planes_2d(table, device)
    tab8 = bigtable_device_table(table, device)
    onehot_tab = bigtable_kmajor(tab8) if torch.device(device).type == "cuda" else tab8

    def rows_plain(l, r):
        return probe_rows_torch(planes, sb, mp, l, r)

    return {
        "lookup_pairs": (
            lambda l, r: merge_cuda.lookup_pairs(tab, l.reshape(-1), r.reshape(-1), **kw)
            .reshape(l.shape),
            lambda l, r: lookup_pairs_torch(tab, sb, mp, l, r),
        ),
        "probe_rows_async": (
            lambda l, r: probe_cuda.probe_rows_async(planes, l, r, **kw),
            rows_plain,
        ),
        "probe_rows_resident": (
            lambda l, r: probe_cuda.probe_rows_resident(planes, l, r, **kw),
            rows_plain,
        ),
        "lookup_onehot": (
            lambda l, r: probe_cuda.lookup_onehot(onehot_tab, l, r, **kw),
            lambda l, r: lookup_onehot_torch(tab8, l, r, **kw),
        ),
    }


def onehot_product(tab_k: torch.Tensor, left: torch.Tensor, right: torch.Tensor, *,
                   slot_bits: int, max_probes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's whole product as plain matrices ``(A, B, target)``, for a
    library GEMM to be timed beside the kernel on the same work.

    ``A`` is the one-hot ``[M, K]`` int8 (M = S * 128 * max_probes, K =
    n_rows): row ``p * S * 128 + i`` has its 1 at the row of pair i's slot
    at round p, as the kernel's rows do.  ``B`` is the K-major table
    ``tab_k`` (:func:`.exp_probe_torch.bigtable_kmajor`) viewed as
    ``[K, N]``, a column-major view, N = 1,536.  Row m of ``A @ B`` is
    row ``target[m]`` of B, so a caller checks a product by ``B[target]``.
    """
    slot, _live = hash_slots(left.reshape(-1), right.reshape(-1), slot_bits)
    rounds = torch.arange(max_probes, device=slot.device, dtype=slot.dtype)[:, None]
    target = (((slot[None, :] + rounds) & ((1 << slot_bits) - 1)) // 128).reshape(-1)
    a = torch.zeros((target.numel(), tab_k.shape[1]), dtype=torch.int8, device=tab_k.device)
    a[torch.arange(target.numel(), device=tab_k.device), target] = 1
    return a, tab_k.t(), target


def l2_for(arm: str, table, device):
    """The context an arm runs in: K4's L2 set-aside sized to the table's
    three planes, nothing for the others."""
    if arm == "probe_rows_resident":
        return probe_cuda.persisting_l2(3 * table.n_slots * 4, device)
    return contextlib.nullcontext()


def run_arms(table, device, shape=SHAPE, reps: int = REPS, arms=None) -> List[dict]:
    """Run every arm (or those named in ``arms``) on ``device`` on one
    ``make_probes`` tile of ``shape``; one record per arm, its ``shape``
    naming the tile.

    Each record has ``plain_bit_exact`` (the plain PyTorch version equals
    ``PairTable.lookup``).  On a CUDA device it also has ``bit_exact`` (the
    kernel does); ``ms`` and ``plain_ms``, medians of ``reps`` CUDA-event
    timings of one call after a warm-up, with the table warm in L2 (at
    ``SHAPE``, where a probe kernel takes a few µs, ``ms`` measures the
    host's enqueue, not the kernel); ``device_us``, the kernel's device
    time per call from :func:`queued_ms`, at every tile; and
    ``plain_device_us``, the plain version's summed device rows from
    :func:`device_us` (its host time, milliseconds a call, is far longer
    than its device time, so it is not queued).  K4's arm runs inside
    :func:`.probe_cuda.persisting_l2` sized to its planes.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_arms on cuda: torch.cuda.is_available() is False")
    l_np, r_np = make_probes(table, shape)
    want = table.lookup(l_np, r_np)
    left = torch.from_numpy(l_np).to(device)
    right = torch.from_numpy(r_np).to(device)
    calls = arm_calls(table, device)
    records = []
    for arm, source, replaces in ARMS:
        if arms is not None and arm not in arms:
            continue
        kernel = functools.partial(calls[arm][0], left, right)
        plain = functools.partial(calls[arm][1], left, right)
        rec = {"arm": arm, "source": source, "replaces": replaces, "device": str(device),
               "shape": list(shape)}
        got_plain = plain()
        rec["plain_bit_exact"] = bool(np.array_equal(got_plain.cpu().numpy(), want))
        if device.type == "cuda":
            with l2_for(arm, table, device):
                got = kernel()
                rec["bit_exact"] = bool(np.array_equal(got.cpu().numpy(), want))
                rec["ms"] = median_ms(kernel, reps)
                rec["device_us"] = queued_ms(kernel, reps) * 1e3
            rec["plain_ms"] = median_ms(plain, reps)
            rec["plain_device_us"] = device_us(plain, reps)
        records.append(rec)
    return records
