"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The kernels have a plain C interface: ``nvcc`` compiles each source for
Hopper (``sm_90a``), all sources at once, and links them into one shared
library, which is loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.  The
library lands in ``<cache>/cuda/``, where ``<cache>`` is
``TOKENIZER_TPU_CACHE_DIR`` (by default ``~/.cache/tokenizer_tpu``; the
port's native scanner builds beside it in ``<cache>/native_torch/``).
It is named by a hash of the sources and flags, so an edit rebuilds and
an unchanged tree reuses it.  A missing ``nvcc`` or
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

from ..vocab import default_cache_dir

__all__ = ["build_dir", "build_library", "load_library", "SOURCES", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "merge_packed.cu", CSRC / "probe_rows.cu", CSRC / "lookup_onehot.cu")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
_TIMEOUT_S = 600

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the kernel library is built: ``<cache>/cuda``."""
    return default_cache_dir() / "cuda"


def _run_together(cmds) -> str:
    """Start every command at once, wait for all, raise if one failed.

    Returns their stderr, concatenated in order."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    try:
        errs = [p.communicate(timeout=_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err[-4000:]}")
    return "".join(errs)


def build_library() -> Tuple[Path, str]:
    """Compile the kernels unless this source hash is built.

    One ``nvcc -c`` per source, all started together, then one link.
    Returns the library's path and nvcc's report (registers and spills
    per kernel from ``-Xptxas -v``), which is empty when the library was
    already on disk.
    """
    out_dir = build_dir()
    lib = out_dir / f"libtt_kernels-{_digest()}.so"
    if lib.is_file():
        return lib, ""
    work = out_dir / f".build-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        objs = [work / f"{src.stem}.o" for src in SOURCES]
        report = _run_together(
            [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for o, s in zip(objs, SOURCES)]
        )
        tmp = work / "lib.so"
        _run_together([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, report


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()[0]))
            merge = [
                _P, _P, _P, _I, _I,  # key_left, key_right, values, slot_bits, max_probes
                _P, _P, _P, _P,  # ids, lengths, out_ids, out_n
            ]
            lib.tt_merge_packed.restype = _I
            lib.tt_merge_packed.argtypes = merge + [_I, _I, _P]  # L, B, stream
            lib.tt_merge_packed_v1.restype = _I
            lib.tt_merge_packed_v1.argtypes = merge + [_P, _I, _I, _P]  # rank_scratch, L, B, stream
            probe = [
                _P, _P, _P, _I, _I,  # key_left, key_right, values, slot_bits, max_probes
                _P, _P, _P, ctypes.c_longlong,  # left, right, out, n
            ]
            lib.tt_lookup_pairs.restype = _I
            lib.tt_lookup_pairs.argtypes = probe + [_P]  # stream
            lib.tt_probe_rows_async.restype = _I
            lib.tt_probe_rows_async.argtypes = probe + [_P]  # stream
            lib.tt_probe_rows_resident.restype = _I
            lib.tt_probe_rows_resident.argtypes = probe + [
                _P, ctypes.c_size_t, _P,  # window base, window bytes, stream
            ]
            lib.tt_lookup_onehot.restype = _I
            lib.tt_lookup_onehot.argtypes = [
                _P, _I, _I, _I,  # tab_t [4, 384, n_rows], n_rows, slot_bits, max_probes
                _P, _P, _P, _P, _I, _P,  # left, right, out, scratch, S, stream
            ]
            lib.tt_l2_persist_attrs.restype = _I
            lib.tt_l2_persist_attrs.argtypes = [_P, _P, _P]  # int*, int*, size_t* (out)
            lib.tt_l2_persist_set.restype = _I
            lib.tt_l2_persist_set.argtypes = [ctypes.c_size_t]
            lib.tt_l2_persist_reset.restype = _I
            lib.tt_l2_persist_reset.argtypes = []
            lib.tt_error_string.restype = ctypes.c_char_p
            lib.tt_error_string.argtypes = [_I]
            _LIB = lib
        return _LIB
