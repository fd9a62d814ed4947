"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The kernels have a plain C interface: ``nvcc`` compiles them for Hopper
(``sm_90a``) into one shared library, which is loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.  The
library lands in ``<cache>/cuda/``, where ``<cache>`` is the JAX
package's cache directory (``TOKENIZER_TPU_CACHE_DIR``, by default
``~/.cache/tokenizer_tpu``; the native scanner builds beside it in
``<cache>/native/``).  It is named by a hash of the sources and flags, so
an edit rebuilds and an unchanged tree reuses it.  A missing ``nvcc`` or
a failed compile raises: there is no fallback to the plain PyTorch
version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

from tokenizer_tpu.vocab import default_cache_dir

__all__ = ["build_dir", "build_library", "load_library", "SOURCES", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "merge_packed.cu",)
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA kernels "
            "of tokenizer_tpu_torch need the CUDA toolkit"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the kernel library is built: ``<cache>/cuda``."""
    return default_cache_dir() / "cuda"


def build_library() -> Tuple[Path, str]:
    """Compile the kernels unless this source hash is built.

    Returns the library's path and nvcc's report (registers and spills
    per kernel from ``-Xptxas -v``), which is empty when the library was
    already on disk.
    """
    out_dir = build_dir()
    lib = out_dir / f"libtt_kernels-{_digest()}.so"
    if lib.is_file():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".build-{os.getpid()}-{threading.get_ident()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib, res.stderr


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()[0]))
            lib.tt_merge_packed.restype = _I
            lib.tt_merge_packed.argtypes = [
                _P, _P, _P, _I, _I,  # key_left, key_right, values, slot_bits, max_probes
                _P, _P, _P, _P, _P,  # ids, lengths, out_ids, out_n, rank_scratch
                _I, _I, _P,  # L, B, stream
            ]
            lib.tt_lookup_pairs.restype = _I
            lib.tt_lookup_pairs.argtypes = [
                _P, _P, _P, _I, _I,  # key_left, key_right, values, slot_bits, max_probes
                _P, _P, _P, ctypes.c_longlong, _P,  # left, right, out, n, stream
            ]
            lib.tt_error_string.restype = ctypes.c_char_p
            lib.tt_error_string.argtypes = [_I]
            _LIB = lib
        return _LIB
