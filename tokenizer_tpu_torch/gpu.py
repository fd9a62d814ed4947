"""GpuTokenizer: the JAX package's bulk tokenizer with its merge on a CUDA card.

:class:`GpuTokenizer` subclasses :class:`tokenizer_tpu.tpu.TpuTokenizer`
and keeps all of its host layers: the native C++ scan, interning and
dedup, the in-scan id emit, the row scatter, the trims and the decode.
It replaces only the device plumbing.  Every first-seen wave that the
router sends to the device is packed into ``[L, B]`` int32 tiles
(:func:`tokenizer_tpu.ops.packing.pack_spans`), each tile is copied to the
card and merged by one launch of the hand-written CUDA kernel
(:func:`tokenizer_tpu_torch.ops.merge_cuda.merge_packed`) on the current
stream, and the wave's outputs come back in one device-to-host copy.

The JAX package's tunnel economics are gone: there is no background
channel probe that turns errors into host mode, no wave-shape pre-arm
history on disk, and no flat-buffer fusion of a wave into one jit call
(``TpuTokenizer._start_channel_probe``, ``_device_tab``, ``_wave_fn``,
``_mesh_wave_fn`` and ``_prearm_wave_fns`` are never reached, because the
methods that called them are replaced here).
The device is set up synchronously at the first device wave, and every
error there reaches the caller.

``device="cpu"`` runs the same plumbing with the plain PyTorch merge; it
exists for the tests, which have no card.
"""

from __future__ import annotations

import contextlib
from functools import partial

import numpy as np
import torch

from tokenizer_tpu.tpu import _HOST_WAVE_MAX, TpuTokenizer
from tokenizer_tpu.utils.lru import DEFAULT_CACHE_SIZE

from .ops.merge_cuda import LANE, merge_packed
from .ops.merge_torch import device_table

__all__ = ["GpuTokenizer"]


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device with an index; raises where it cannot run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' for the plain PyTorch merge"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"GpuTokenizer runs on 'cuda' or 'cpu', not {dev}")
    return dev


class GpuTokenizer(TpuTokenizer):
    """Drop-in for TpuTokenizer whose merge kernel runs on a CUDA card."""

    def __init__(
        self,
        ranks_or_path,
        special_tokens,
        pattern: str,
        cache_size: int = DEFAULT_CACHE_SIZE,
        max_unique_rows: int = 1 << 20,
        device="cuda",
    ):
        dev = _resolve_device(device)
        super().__init__(
            ranks_or_path,
            special_tokens,
            pattern,
            cache_size,
            mesh=None,
            max_unique_rows=max_unique_rows,
        )
        self.device = dev
        #: waves of at most this many first-seen pieces merge on the host
        #: (the JAX package's _HOST_WAVE_MAX, not yet re-measured on a card).
        self._host_wave_max = _HOST_WAVE_MAX

    # -- device plumbing ----------------------------------------------------

    def _ensure_device(self) -> int:
        """Upload the pair table and load the kernel; returns the B quantum.

        Synchronous, once per tokenizer.  On CUDA the first call builds
        the kernel library with nvcc if this source hash is not built yet.
        """
        if self._merge_fn is None:
            if self.device.type == "cuda":
                from .runtime.build import load_library

                load_library()
            self._tab_dev = device_table(self.table, self.device)
            self._b_quantum = LANE
            self._merge_fn = partial(
                merge_packed,
                slot_bits=self.table.slot_bits,
                max_probes=self.table.max_probes,
            )
        return self._b_quantum

    def _route_wave_host(self, n_wave: int) -> bool:
        """The JAX package's routing rule without the probe and grace wait.

        Waves of at most ``_host_wave_max`` pieces go to the host C++
        merge; larger ones go to the card unless the blocking cost per
        piece measured so far favours the host, with a device wave after
        every 32 host waves so that the estimate stays current.
        """
        if self._native is None:
            self._ensure_device()
            return False
        return n_wave <= self._host_wave_max or (
            self._dev_pp is not None
            and self._dev_pp > self._host_pp
            and self._host_waves_since_dev < 32
        )

    def _device_merge_async(self, ids: np.ndarray, lengths: np.ndarray):
        """Copy one numpy tile to the device and launch its merge."""
        self._ensure_device()
        return self._merge_fn(
            self._tab_dev,
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )

    def _dispatch_tiles(self, batches):
        """One merge launch per tile on the current stream.

        Returns ``(outs, stream)``: the per-tile output tensors and the
        stream they were launched on (None on the CPU), which
        :meth:`_bucket_out` copies back on.  A stream chunk's wave may be
        finished in a later step, on another thread.
        """
        stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda"
            else None
        )
        outs = [self._device_merge_async(b.ids, b.lengths) for b in batches]
        return outs, stream

    def _bucket_out(self, batches, outs, stream):
        """One ``torch.cat`` and one device-to-host copy for the whole
        wave, then the JAX package's split into per-tile ``([B, L]
        out_rows, out_n)`` pairs and its device-piece count."""
        if not outs:
            return []
        on_stream = (
            torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        )
        with on_stream:
            flat = torch.cat(
                [o.reshape(-1) for o, _ in outs] + [n for _, n in outs]
            ).cpu()
        return super()._bucket_out(batches, None, flat.numpy())
