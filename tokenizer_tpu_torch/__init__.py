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
``encode_batch`` and ``encode_batch_stream`` through that kernel, on one
device or sharded over a :class:`DataMesh` (``parallel/mesh``,
``parallel/encode_step``); and the corpus path around it:
``runtime/pipeline`` (``encode_corpus``), ``runtime/perf``,
``runtime/profiler``, ``parallel/multihost`` (torch.distributed) and the
CLI (``tokenizer-tpu-torch``).

The public surface is the JAX package's, with :class:`GpuTokenizer` in
place of ``TpuTokenizer``.  Importing this package imports torch but
neither jax nor anything of ``tokenizer_tpu``, and builds nothing: the
kernel library is compiled with nvcc at its first use on a card.
"""

from .bpe import byte_pair_encode
from .builder import create_by_encoder_name, create_by_model_name, create_tokenizer
from .engine import ALL_SPECIAL_TOKENS, TikTokenizer, TrimResult
from .gpu import GpuTokenizer
from .models.registry import (
    MODEL_TO_ENCODING,
    REGEX_PATTERN_1,
    REGEX_PATTERN_2,
    REGEX_PATTERN_3,
    encoding_name_for_model,
    get_regex_by_encoder,
    get_regex_by_model,
    get_special_tokens_by_encoder,
    get_special_tokens_by_model,
)
from .parallel.mesh import DataMesh, data_mesh
from .utils.lru import LRUCache
from .vocab import Vocabulary, load_tiktoken_file, parse_tiktoken_data

__version__ = "0.1.0"

__all__ = [
    "TikTokenizer",
    "TrimResult",
    "ALL_SPECIAL_TOKENS",
    "byte_pair_encode",
    "create_by_model_name",
    "create_by_encoder_name",
    "create_tokenizer",
    "encoding_name_for_model",
    "MODEL_TO_ENCODING",
    "get_regex_by_encoder",
    "get_regex_by_model",
    "get_special_tokens_by_encoder",
    "get_special_tokens_by_model",
    "REGEX_PATTERN_1",
    "REGEX_PATTERN_2",
    "REGEX_PATTERN_3",
    "LRUCache",
    "Vocabulary",
    "load_tiktoken_file",
    "parse_tiktoken_data",
    "GpuTokenizer",
    "DataMesh",
    "data_mesh",
]
