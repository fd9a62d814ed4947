"""tokenizer_tpu_torch — the PyTorch / CUDA port of tokenizer_tpu.

The JAX package's host layers (native C++ pre-split, interning, dedup,
in-scan id emit, trims, decode) are imported from ``tokenizer_tpu``,
none of which imports JAX.  This package owns the device layer: the
pair table as torch tensors, the packed merge as a hand-written CUDA
kernel for Hopper (``csrc/merge_packed.cu``) with its plain PyTorch
version, and :class:`GpuTokenizer`, which routes ``encode_batch`` and
``encode_batch_stream`` through that kernel.

Importing this package imports torch but never jax, and builds nothing:
the kernel library is compiled with nvcc at its first use on a card.
"""

from .builder import create_by_encoder_name, create_by_model_name, create_tokenizer
from .gpu import GpuTokenizer

__all__ = [
    "GpuTokenizer",
    "create_by_encoder_name",
    "create_by_model_name",
    "create_tokenizer",
]
