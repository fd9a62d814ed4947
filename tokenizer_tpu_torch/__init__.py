"""tokenizer_tpu_torch — the PyTorch / CUDA port of tokenizer_tpu.

The package stands on its own.  It keeps its own copies of the JAX
package's host layers, under the same module names: the engine, bpe,
vocab (with the vendored gpt2 rank file), the model registry,
``utils/``, ``ops/pair_table`` and ``ops/packing``, and the native C++
pre-split, interning, dedup and in-scan id emit (``runtime/native``,
built into a cache directory of its own).  On top of them it has the
device layer: the pair table as torch tensors, the packed merge as a
hand-written CUDA kernel for Hopper (``csrc/merge_packed.cu``) with its
plain PyTorch version, and :class:`GpuTokenizer`, which routes
``encode_batch`` and ``encode_batch_stream`` through that kernel.

Importing this package imports torch but neither jax nor anything of
``tokenizer_tpu``, and builds nothing: the kernel library is compiled
with nvcc at its first use on a card.
"""

from .builder import create_by_encoder_name, create_by_model_name, create_tokenizer
from .gpu import GpuTokenizer

__all__ = [
    "GpuTokenizer",
    "create_by_encoder_name",
    "create_by_model_name",
    "create_tokenizer",
]
