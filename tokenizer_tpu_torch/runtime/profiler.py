"""Profiling and throughput: the port's counterpart of
:mod:`tokenizer_tpu.runtime.profiler`.

* :func:`trace` — context manager around ``torch.profiler.profile``
  (host activity, plus the card's when one is present); writes a
  Chrome / Perfetto trace (``*.pt.trace.json``) into ``log_dir``,
  viewable in ui.perfetto.dev or ``chrome://tracing``.
* :class:`ThroughputMeter` — wall-clock bytes/s and tokens/s meter whose
  :meth:`~ThroughputMeter.block_until_ready` synchronizes the card(s)
  holding a result, so device work lands inside the timed window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

__all__ = ["trace", "ThroughputMeter"]


@contextlib.contextmanager
def trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def _cuda_devices(tree, out: set) -> set:
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class ThroughputMeter:
    """Accumulates (bytes, tokens, seconds) across timed sections."""

    def __init__(self):
        self.bytes = 0
        self.tokens = 0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None

    def add(self, nbytes: int = 0, ntokens: int = 0):
        self.bytes += nbytes
        self.tokens += ntokens

    @property
    def mb_per_s(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    def block_until_ready(self, tree):
        """Fence device work into the timed window: synchronize every
        card that holds a tensor of ``tree`` (nested lists, tuples and
        dicts); CPU tensors and numpy arrays need nothing."""
        import torch

        for device in _cuda_devices(tree, set()):
            torch.cuda.synchronize(device)
        return tree
