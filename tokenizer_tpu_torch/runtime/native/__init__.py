"""ctypes binding + on-demand build of the native pre-tokenizer.

The shared library builds once per machine with the system g++ (no
pybind11 dependency — plain C ABI) into the user cache dir; a missing
toolchain degrades gracefully (``available()`` returns False and
callers fall back to the python `regex` path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "presplit",
    "bpe_encode",
    "bpe_encode_batch",
    "bpe_encode_batch_spans",
    "SplitContext",
    "PATTERN_IDS",
]

_SRC_DIR = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

#: registry pattern -> native scanner id.
PATTERN_IDS = {
    "p1": 1,  # gpt2 / r50k_base / p50k_base / p50k_edit
    "p2": 2,  # cl100k_base
    "p3": 3,  # o200k_base
}


def _errmsg(fn: str, rc: int) -> str:
    if rc == -5:
        return (
            f"{fn} failed: buffer exceeds 2 GiB (int32 piece offsets);"
            " split the batch into smaller chunks"
        )
    return f"{fn} failed: {rc}"


def _cache_dir() -> Path:
    env = os.environ.get("TOKENIZER_TPU_CACHE_DIR")
    base = Path(env) if env else Path.home() / ".cache" / "tokenizer_tpu"
    # Not "native": the JAX package builds its own copy there, and the two
    # packages must never load each other's library.
    return base / "native_torch"


def _build() -> Optional[Path]:
    src = _SRC_DIR / "presplit.cpp"
    hdr = _SRC_DIR / "unicode_tables.h"
    if not (src.is_file() and hdr.is_file()):
        return None
    out_dir = _cache_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    stamp = f"{src.stat().st_mtime_ns}-{hdr.stat().st_mtime_ns}"
    lib = out_dir / f"libttpresplit-{stamp}.so"
    if lib.is_file():
        return lib
    tmp = out_dir / f".build-{os.getpid()}.so"
    def _compile(extra):
        cmd = [
            os.environ.get("CXX", "g++"),
            "-O3",
            *extra,
            "-fno-exceptions",
            "-pthread",
            "-shared",
            "-fPIC",
            str(src),
            "-o",
            str(tmp),
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)

    try:
        _compile(["-march=native"])
    except (OSError, subprocess.SubprocessError):
        try:
            _compile([])  # older toolchains / cross environments
        except (OSError, subprocess.SubprocessError):
            return None
    os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("TOKENIZER_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.tt_presplit.restype = ctypes.c_int64
        lib.tt_presplit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.tt_ctx_new.restype = ctypes.c_void_p
        lib.tt_ctx_new.argtypes = [ctypes.c_int]
        lib.tt_ctx_free.restype = None
        lib.tt_ctx_free.argtypes = [ctypes.c_void_p]
        lib.tt_ctx_n_pieces.restype = ctypes.c_int64
        lib.tt_ctx_n_pieces.argtypes = [ctypes.c_void_p]
        lib.tt_ctx_split.restype = ctypes.c_int64
        lib.tt_ctx_split.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tt_ctx_split_batch.restype = ctypes.c_int64
        lib.tt_ctx_split_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tt_ctx_split_merge_batch.restype = ctypes.c_int64
        lib.tt_ctx_split_merge_batch.argtypes = (
            lib.tt_ctx_split_batch.argtypes[:-1]
            + [
                ctypes.POINTER(ctypes.c_int64),  # n_new
                ctypes.c_void_p,  # byte_to_id
                ctypes.c_void_p,  # kl
                ctypes.c_void_p,  # kr
                ctypes.c_void_p,  # vv
                ctypes.c_int32,  # slot_bits
                ctypes.c_int32,  # max_probes
                ctypes.c_void_p,  # rows
                ctypes.c_void_p,  # row_len
                ctypes.c_void_p,  # row_u16
                ctypes.c_int64,  # row_width
                ctypes.c_int64,  # row_cap
                ctypes.c_void_p,  # uid_rows
                ctypes.c_int64,  # uid_cap
                ctypes.POINTER(ctypes.c_int64),  # row_next (in/out)
                ctypes.POINTER(ctypes.c_int64),  # n_fused (out)
                ctypes.c_void_p,  # old_ctx (nullable, frozen)
                ctypes.c_void_p,  # old_uid_rows
                ctypes.c_void_p,  # old_rows
                ctypes.c_void_p,  # old_row_len
                ctypes.c_void_p,  # old_row_u16
                ctypes.c_int64,  # old_row_width
                ctypes.c_int64,  # old_n_rows
                ctypes.POINTER(ctypes.c_int64),  # n_copied (out, nullable)
                ctypes.c_void_p,  # uid_ids (nullable [uid_cap, 8] compact)
            ]
        )
        lib.tt_ctx_split_emit_batch.restype = ctypes.c_int64
        lib.tt_ctx_split_emit_batch.argtypes = [
            ctypes.c_void_p,  # ctx
            ctypes.c_void_p,  # buf
            ctypes.c_void_p,  # seg_start
            ctypes.c_void_p,  # seg_end
            ctypes.c_int64,  # n_segs
            ctypes.c_int,  # nthreads
            ctypes.c_void_p,  # out_ids
            ctypes.c_void_p,  # seg_ntokens
            ctypes.c_void_p,  # seg_npieces
            ctypes.c_void_p,  # new_uid
            ctypes.c_void_p,  # new_start
            ctypes.c_void_p,  # new_end
            ctypes.c_int64,  # new_cap
            ctypes.POINTER(ctypes.c_int64),  # n_new
            ctypes.c_void_p,  # byte_to_id
            ctypes.c_void_p,  # kl
            ctypes.c_void_p,  # kr
            ctypes.c_void_p,  # vv
            ctypes.c_int32,  # slot_bits
            ctypes.c_int32,  # max_probes
            ctypes.c_void_p,  # rows
            ctypes.c_void_p,  # row_len
            ctypes.c_void_p,  # row_u16
            ctypes.c_int64,  # row_width
            ctypes.c_int64,  # row_cap
            ctypes.c_void_p,  # uid_rows
            ctypes.c_int64,  # uid_cap
            ctypes.POINTER(ctypes.c_int64),  # row_next (in/out)
            ctypes.POINTER(ctypes.c_int64),  # n_fused (out)
            ctypes.c_void_p,  # old_ctx (nullable)
            ctypes.c_void_p,  # old_uid_rows
            ctypes.c_void_p,  # old_rows
            ctypes.c_void_p,  # old_row_len
            ctypes.c_void_p,  # old_row_u16
            ctypes.c_int64,  # old_row_width
            ctypes.c_int64,  # old_n_rows
            ctypes.POINTER(ctypes.c_int64),  # n_copied (out)
            ctypes.c_void_p,  # ovf_pool (nullable)
            ctypes.c_int64,  # ovf_len
            ctypes.c_void_p,  # patch_seg
            ctypes.c_void_p,  # patch_pos
            ctypes.c_void_p,  # patch_uid
            ctypes.c_void_p,  # patch_res
            ctypes.c_int64,  # patch_cap
            ctypes.POINTER(ctypes.c_int64),  # n_patches
            ctypes.c_void_p,  # uid_ids (nullable [uid_cap, 8] compact)
        ]
        lib.tt_backfill_patches.restype = ctypes.c_int64
        lib.tt_backfill_patches.argtypes = [
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # seg_off
            ctypes.c_void_p,  # seg_ntokens (in/out)
            ctypes.c_void_p,  # patch_seg
            ctypes.c_void_p,  # patch_pos
            ctypes.c_void_p,  # patch_uid
            ctypes.c_void_p,  # patch_res
            ctypes.c_int64,  # n_patches
            ctypes.c_void_p,  # rows
            ctypes.c_void_p,  # row_len
            ctypes.c_int64,  # stride
            ctypes.c_void_p,  # uid_rows
            ctypes.c_void_p,  # ovf_pool (nullable)
        ]
        lib.tt_ctx_lookup_spans.restype = None
        lib.tt_ctx_lookup_spans.argtypes = [
            ctypes.c_void_p,  # ctx (frozen)
            ctypes.c_void_p,  # blob
            ctypes.c_void_p,  # starts
            ctypes.c_void_p,  # ends
            ctypes.c_int64,  # n
            ctypes.c_int64,  # blob_len
            ctypes.c_void_p,  # out_uids
        ]
        lib.tt_gather_bytes.restype = ctypes.c_int64
        lib.tt_gather_bytes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.tt_gather_bytes_batch.restype = ctypes.c_int64
        lib.tt_gather_bytes_batch.argtypes = [
            ctypes.c_void_p,  # blob
            ctypes.c_void_p,  # offs
            ctypes.c_int64,  # n_ids
            ctypes.c_void_p,  # ids (flat)
            ctypes.c_void_p,  # id_bounds
            ctypes.c_int64,  # n_texts
            ctypes.c_int,  # nthreads
            ctypes.c_void_p,  # text_offs (out)
            ctypes.c_void_p,  # out (nullable: phase 1 = sizes)
            ctypes.c_int64,  # out_cap
        ]
        lib.tt_assemble_batch.restype = ctypes.c_int64
        lib.tt_assemble_batch.argtypes = [
            ctypes.c_void_p,  # rows
            ctypes.c_void_p,  # row_len
            ctypes.c_int64,  # stride
            ctypes.c_void_p,  # uid_rows (nullable)
            ctypes.c_void_p,  # uid_buf
            ctypes.c_void_p,  # seg_offs
            ctypes.c_void_p,  # seg_counts
            ctypes.c_int64,  # n_segs
            ctypes.c_int,  # nthreads
            ctypes.c_void_p,  # totals
            ctypes.c_void_p,  # out_offs (nullable)
            ctypes.c_void_p,  # out (nullable)
            ctypes.c_int64,  # out_cap
            ctypes.c_void_p,  # ovf_pool (nullable)
        ]
        lib.tt_bpe_encode.restype = ctypes.c_int64
        lib.tt_bpe_encode.argtypes = [
            ctypes.c_char_p,  # piece
            ctypes.c_int64,  # n
            ctypes.c_void_p,  # byte_to_id
            ctypes.c_void_p,  # key_left
            ctypes.c_void_p,  # key_right
            ctypes.c_void_p,  # values
            ctypes.c_int32,  # slot_bits
            ctypes.c_int32,  # max_probes
            ctypes.c_void_p,  # out
            ctypes.c_int64,  # out_cap
        ]
        lib.tt_bpe_encode_batch.restype = ctypes.c_int64
        lib.tt_bpe_encode_batch.argtypes = [
            ctypes.c_void_p,  # blob
            ctypes.c_void_p,  # starts
            ctypes.c_void_p,  # ends
            ctypes.c_void_p,  # out_offs
            ctypes.c_int64,  # n_pieces
            ctypes.c_void_p,  # whole_ids (nullable)
            ctypes.c_void_p,  # byte_to_id
            ctypes.c_void_p,  # key_left
            ctypes.c_void_p,  # key_right
            ctypes.c_void_p,  # values
            ctypes.c_int32,  # slot_bits
            ctypes.c_int32,  # max_probes
            ctypes.c_int,  # nthreads
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # out_counts
        ]
        if lib.tt_abi_version() != 11:
            return None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def default_threads() -> int:
    """Worker threads for the native scan/merge/assemble calls.

    ``TOKENIZER_TPU_THREADS`` overrides (ops knob: shared/steal-heavy
    hosts often run best below the vCPU count); default caps at 16.
    """
    env = os.environ.get("TOKENIZER_TPU_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(os.cpu_count() or 1, 16)


def _uid_ids_ptr(uid_ids: Optional[np.ndarray], uid_rows: np.ndarray):
    """Pointer for the compact [uid_cap, 8] id table (nullable).

    MUST stay capacity-lockstep with ``uid_rows``: the native fuse
    writes ``uid_ids[uid]`` for any uid < len(uid_rows), so a shorter
    table would be an out-of-bounds write."""
    if uid_ids is None:
        return None
    assert (
        uid_ids.dtype == np.int32
        and uid_ids.flags.c_contiguous
        and uid_ids.shape == (len(uid_rows), 8)
    ), "uid_ids must be int32 [len(uid_rows), 8] C-contiguous"
    return uid_ids.ctypes.data_as(ctypes.c_void_p)


def presplit(
    data: bytes, pattern_id: int, start: int = 0, end: Optional[int] = None
) -> np.ndarray:
    """Piece END byte offsets for buf[start:end). Raises if unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native presplit unavailable")
    if end is None:
        end = len(data)
    cap = max(end - start, 1)
    out = np.empty(cap, dtype=np.int32)
    n = lib.tt_presplit(
        data,
        start,
        end,
        pattern_id,
        out.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if n < 0:
        raise RuntimeError(_errmsg("tt_presplit", n))
    return out[:n]


class SplitContext:
    """Persistent native split + interning context (one per tokenizer).

    ``split`` returns (piece_uids, new_pieces) where uids are stable
    across calls and ``new_pieces`` lists (uid, bytes) pairs first seen
    in this call.  Not thread-safe.
    """

    #: generations a returned uid buffer stays valid (see split_batch).
    _RING = 4

    def __init__(self, pattern_id: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native presplit unavailable")
        self._lib = lib
        self._ctx = lib.tt_ctx_new(pattern_id)
        if not self._ctx:
            raise RuntimeError("tt_ctx_new failed")
        # Grow-only scratch: fresh multi-MB np.empty per call costs more
        # in page faults than the scan itself on large batches.  The uid
        # ring keeps the last _RING results alive so the pipelined
        # stream (depth 2) can still hold batch k while k+1 splits.
        self._uid_ring: list = [None] * self._RING
        self._uid_ring_i = 0
        self._news_scratch = None
        #: monotonically increasing per split_batch call; the buffer
        #: handed out at generation g is recycled at g + _RING, so
        #: consumers assert currency via check_uid_generation.
        self.generation = 0

    def check_uid_generation(self, gen: int) -> None:
        """Assert that a split_batch uid buffer from generation ``gen``
        has not been recycled — the consumer-side enforcement of the
        OWNERSHIP contract below (silent corruption otherwise)."""
        if self.generation - gen >= self._RING:
            raise RuntimeError(
                f"split_batch uid buffer from generation {gen} was "
                f"recycled (current {self.generation}, ring {self._RING});"
                " copy the buffer to retain it across more calls"
            )

    def _uid_buffer(self, cap: int) -> np.ndarray:
        i = self._uid_ring_i
        self._uid_ring_i = (i + 1) % self._RING
        buf = self._uid_ring[i]
        if buf is None or len(buf) < cap:
            buf = np.empty(max(cap, 1 << 16), dtype=np.int32)
            self._uid_ring[i] = buf
        return buf

    def _news_buffers(self, cap: int):
        tr = self._news_scratch
        if tr is None or len(tr[0]) < cap:
            tr = tuple(
                np.empty(max(cap, 1 << 16), dtype=np.int32) for _ in range(3)
            )
            self._news_scratch = tr
        return tr

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.tt_ctx_free(ctx)
            self._ctx = None

    @property
    def n_pieces(self) -> int:
        return self._lib.tt_ctx_n_pieces(self._ctx)

    def split(
        self, data: bytes, start: int = 0, end: Optional[int] = None
    ) -> Tuple[np.ndarray, list]:
        if end is None:
            end = len(data)
        cap = max(end - start, 1)
        piece_uid = np.empty(cap, dtype=np.int32)
        new_uid = np.empty(cap, dtype=np.int32)
        new_start = np.empty(cap, dtype=np.int32)
        new_end = np.empty(cap, dtype=np.int32)
        n_new = ctypes.c_int64(0)
        n = self._lib.tt_ctx_split(
            self._ctx,
            data,
            start,
            end,
            piece_uid.ctypes.data_as(ctypes.c_void_p),
            cap,
            new_uid.ctypes.data_as(ctypes.c_void_p),
            new_start.ctypes.data_as(ctypes.c_void_p),
            new_end.ctypes.data_as(ctypes.c_void_p),
            cap,
            ctypes.byref(n_new),
        )
        if n < 0:
            raise RuntimeError(_errmsg("tt_ctx_split", n))
        news = [
            (int(new_uid[j]), data[new_start[j] : new_end[j]])
            for j in range(n_new.value)
        ]
        return piece_uid[:n], news

    def split_batch(
        self,
        data: bytes,
        seg_start: np.ndarray,
        seg_end: np.ndarray,
        nthreads: int = 0,
    ):
        """Parallel scan + deterministic intern over many segments.

        Returns (piece_uid_buffer, seg_offsets, seg_counts, news):
        segment k's uids are ``buffer[seg_offsets[k] :
        seg_offsets[k] + seg_counts[k]]``.

        OWNERSHIP: the returned uid buffer belongs to this context and
        is recycled after ``_RING`` further ``split_batch`` calls — copy
        it to retain it longer.  (The production pipeline holds at most
        two generations in flight.)  Each call bumps :attr:`generation`;
        consumers record it and call :meth:`check_uid_generation` before
        reading the buffer, turning a stale read into a hard error.
        """
        if nthreads <= 0:
            nthreads = default_threads()
        n_segs = len(seg_start)
        if n_segs == 0:
            return np.empty(0, np.int32), np.empty(0, np.int64), np.empty(
                0, np.int64
            ), tuple(np.empty(0, np.int32) for _ in range(3))
        seg_start = np.ascontiguousarray(seg_start, dtype=np.int64)
        seg_end = np.ascontiguousarray(seg_end, dtype=np.int64)
        base = int(seg_start[0])
        cap = max(int(seg_end[-1]) - base, 1)
        self.generation += 1  # a ring slot is about to be recycled
        piece_uid = self._uid_buffer(cap)
        seg_np = np.empty(n_segs, dtype=np.int64)
        new_uid, new_start, new_end = self._news_buffers(cap)
        n_new = ctypes.c_int64(0)
        rc = self._lib.tt_ctx_split_batch(
            self._ctx,
            data,
            seg_start.ctypes.data_as(ctypes.c_void_p),
            seg_end.ctypes.data_as(ctypes.c_void_p),
            n_segs,
            nthreads,
            piece_uid.ctypes.data_as(ctypes.c_void_p),
            seg_np.ctypes.data_as(ctypes.c_void_p),
            new_uid.ctypes.data_as(ctypes.c_void_p),
            new_start.ctypes.data_as(ctypes.c_void_p),
            new_end.ctypes.data_as(ctypes.c_void_p),
            cap,
            ctypes.byref(n_new),
        )
        if rc < 0:
            raise RuntimeError(_errmsg("tt_ctx_split_batch", rc))
        k = n_new.value
        # First-seen pieces as ARRAYS of byte ranges into ``data`` (no
        # per-piece bytes objects — a cold 8 MB corpus interns ~1e5
        # pieces and the PyBytes churn dominated registration).
        news = (
            new_uid[:k].copy(),
            new_start[:k].copy(),
            new_end[:k].copy(),
        )
        offsets = seg_start - base
        return piece_uid, offsets, seg_np, news

    def split_merge_batch(
        self,
        data: bytes,
        seg_start: np.ndarray,
        seg_end: np.ndarray,
        table,
        rows: np.ndarray,
        row_len: np.ndarray,
        row_u16: np.ndarray,
        uid_rows: np.ndarray,
        n_rows: int,
        nthreads: int = 0,
        old_gen=None,
        uid_ids: Optional[np.ndarray] = None,
    ):
        """:meth:`split_batch` + fused first-seen merge (cold path).

        First-seen pieces are byte-pair-merged ON the scanning threads
        and written straight into ``rows``/``row_len``/``row_u16`` with
        ``uid_rows[uid] = row`` — no separate registration, merge, or
        scatter pass.  Pieces that cannot be fused (row/uid capacity,
        or a merge wider than a row) come back in ``news`` exactly as
        from :meth:`split_batch`.  Returns ``(piece_uid_buffer,
        seg_offsets, seg_counts, news, new_n_rows, n_fused, n_copied)``;
        the caller commits ``new_n_rows`` as its row high-water mark.
        The same buffer-OWNERSHIP/generation contract as split_batch
        applies.

        ``old_gen`` (optional) is a FROZEN retired dedup generation
        ``(ctx, uid_rows, rows, row_len, row_u16, n_rows)``: first-seen
        pieces probe it lock-free and copy already-resolved rows instead
        of re-merging (generational eviction); ``n_copied`` counts the
        copies.
        """
        if nthreads <= 0:
            nthreads = default_threads()
        n_segs = len(seg_start)
        if n_segs == 0:
            empty_news = tuple(np.empty(0, np.int32) for _ in range(3))
            return (
                np.empty(0, np.int32),
                np.empty(0, np.int64),
                np.empty(0, np.int64),
                empty_news,
                n_rows,
                0,
                0,
            )
        seg_start = np.ascontiguousarray(seg_start, dtype=np.int64)
        seg_end = np.ascontiguousarray(seg_end, dtype=np.int64)
        base = int(seg_start[0])
        cap = max(int(seg_end[-1]) - base, 1)
        self.generation += 1
        piece_uid = self._uid_buffer(cap)
        seg_np = np.empty(n_segs, dtype=np.int64)
        new_uid, new_start, new_end = self._news_buffers(cap)
        n_new = ctypes.c_int64(0)
        row_next = ctypes.c_int64(int(n_rows))
        n_fused = ctypes.c_int64(0)
        n_copied = ctypes.c_int64(0)
        assert rows.flags.c_contiguous and rows.dtype == np.int32
        if old_gen is not None:
            octx, ouid_rows, orows, orow_len, orow_u16, on_rows = old_gen
            assert orows.flags.c_contiguous and orows.dtype == np.int32
            old_args = (
                octx._ctx,
                ouid_rows.ctypes.data_as(ctypes.c_void_p),
                orows.ctypes.data_as(ctypes.c_void_p),
                orow_len.ctypes.data_as(ctypes.c_void_p),
                orow_u16.ctypes.data_as(ctypes.c_void_p),
                orows.shape[1],
                int(on_rows),
            )
        else:
            old_args = (None, None, None, None, None, 0, 0)
        rc = self._lib.tt_ctx_split_merge_batch(
            self._ctx,
            data,
            seg_start.ctypes.data_as(ctypes.c_void_p),
            seg_end.ctypes.data_as(ctypes.c_void_p),
            n_segs,
            nthreads,
            piece_uid.ctypes.data_as(ctypes.c_void_p),
            seg_np.ctypes.data_as(ctypes.c_void_p),
            new_uid.ctypes.data_as(ctypes.c_void_p),
            new_start.ctypes.data_as(ctypes.c_void_p),
            new_end.ctypes.data_as(ctypes.c_void_p),
            cap,
            ctypes.byref(n_new),
            table.byte_to_id.ctypes.data_as(ctypes.c_void_p),
            table.key_left.ctypes.data_as(ctypes.c_void_p),
            table.key_right.ctypes.data_as(ctypes.c_void_p),
            table.values.ctypes.data_as(ctypes.c_void_p),
            table.slot_bits,
            table.max_probes,
            rows.ctypes.data_as(ctypes.c_void_p),
            row_len.ctypes.data_as(ctypes.c_void_p),
            row_u16.ctypes.data_as(ctypes.c_void_p),
            rows.shape[1],
            rows.shape[0],
            uid_rows.ctypes.data_as(ctypes.c_void_p),
            len(uid_rows),
            ctypes.byref(row_next),
            ctypes.byref(n_fused),
            *old_args,
            ctypes.byref(n_copied),
            _uid_ids_ptr(uid_ids, uid_rows),
        )
        if rc < 0:
            raise RuntimeError(_errmsg("tt_ctx_split_merge_batch", rc))
        k = n_new.value
        news = (
            new_uid[:k].copy(),
            new_start[:k].copy(),
            new_end[:k].copy(),
        )
        offsets = seg_start - base
        return (
            piece_uid,
            offsets,
            seg_np,
            news,
            int(row_next.value),
            int(n_fused.value),
            int(n_copied.value),
        )

    #: patch scratch capacity (holes are capacity-pressure-rare; -6
    #: overflow routes the caller to the classic two-phase path).
    _PATCH_CAP = 1 << 16

    def _emit_buffer(self, cap: int) -> np.ndarray:
        """Output buffer for split_emit_batch — callers hand out
        ZERO-COPY views of it, so it is reused only when no external
        view keeps it alive (every view holds a reference via ``.base``,
        so the refcount is the ownership oracle).  Consumers that drop
        their outputs promptly (streams, corpus writers) recycle warm
        pages instead of page-faulting a fresh multi-MB buffer per call;
        long-lived outputs silently force fresh allocations."""
        import sys

        pool = getattr(self, "_emit_pool", None)
        if pool is None:
            pool = []
            self._emit_pool = pool
            # Calibrate the "no external views" refcount IN THIS EXACT
            # loop shape: the interpreter's transient stack/iterator
            # references vary by version (3.12 measures 4 where 3.11
            # measured 3), and a wrong constant silently disables reuse
            # — which on this VM costs 0.5-0.8 s of first-touch page
            # faults per fresh 32 MB buffer (measured).
            probe = [np.empty(1, np.int32)]
            for _j, _b in enumerate(probe):
                self._free_refs = sys.getrefcount(_b)
        free = self._free_refs
        for j, b in enumerate(pool):
            if len(b) >= cap and sys.getrefcount(b) <= free:
                pool.append(pool.pop(j))  # MRU
                return b
        buf = np.empty(max(cap, 1 << 16), dtype=np.int32)
        pool.append(buf)
        if len(pool) > 4:
            # Evict the coldest UNREFERENCED buffer; a referenced one
            # must stay pooled (dropping it here would be fine for
            # correctness — views own it — but bounding by unreferenced
            # entries keeps the pool from pinning live outputs).  Same
            # loop shape as the calibration probe (slicing the pool
            # would add a reference and skew the baseline).
            for j, b in enumerate(pool):
                if b is not buf and sys.getrefcount(b) <= free:
                    pool.pop(j)
                    break
        return buf

    def split_emit_batch(
        self,
        data: bytes,
        seg_start: np.ndarray,
        seg_end: np.ndarray,
        table,
        rows: np.ndarray,
        row_len: np.ndarray,
        row_u16: np.ndarray,
        uid_rows: np.ndarray,
        n_rows: int,
        ovf_pool: Optional[np.ndarray] = None,
        nthreads: int = 0,
        old_gen=None,
        fuse: bool = True,
        uid_ids: Optional[np.ndarray] = None,
    ):
        """Fused scan+merge+EMIT: bytes -> token ids in ONE native pass.

        Like :meth:`split_merge_batch` but the per-piece uid buffer is
        never materialized: each segment's token ids land directly at
        ``(seg_start[k] - base)`` of the returned id buffer with counts
        in ``seg_ntokens``.  Pieces that could not resolve inline come
        back as ``patches`` — ``(seg, pos, uid, reserved)`` arrays the
        caller backfills (after resolving the returned ``news``) and
        compacts.  REQUIRES ``uid_rows`` slots for unassigned uids to
        hold -1 (the emit path reads them concurrently under the
        acquire/release protocol; garbage >= 0 would alias rows).

        Returns ``(ids_buffer, seg_offsets, seg_ntokens, seg_npieces,
        news, new_n_rows, n_fused, n_copied, patches)``.  OWNERSHIP:
        the id buffer comes from a refcount-gated pool — it is reused
        ONLY when no live reference (including numpy views, which hold
        it via ``.base``) remains, so handing out zero-copy views is
        safe; holding a RAW pointer/memoryview without a live view
        reference is NOT (see :meth:`_emit_buffer`).
        """
        if nthreads <= 0:
            nthreads = default_threads()
        n_segs = len(seg_start)
        empty_news = tuple(np.empty(0, np.int32) for _ in range(3))
        empty_patches = (
            np.empty(0, np.int64),
            np.empty(0, np.int64),
            np.empty(0, np.int32),
            np.empty(0, np.int32),
        )
        if n_segs == 0:
            return (
                np.empty(0, np.int32),
                np.empty(0, np.int64),
                np.empty(0, np.int64),
                np.empty(0, np.int64),
                empty_news,
                n_rows,
                0,
                0,
                empty_patches,
            )
        seg_start = np.ascontiguousarray(seg_start, dtype=np.int64)
        seg_end = np.ascontiguousarray(seg_end, dtype=np.int64)
        base = int(seg_start[0])
        cap = max(int(seg_end[-1]) - base, 1)
        out_ids = self._emit_buffer(cap)
        seg_nt = np.empty(n_segs, dtype=np.int64)
        seg_np = np.empty(n_segs, dtype=np.int64)
        new_uid, new_start, new_end = self._news_buffers(cap)
        p_scr = getattr(self, "_patch_scratch", None)
        if p_scr is None:
            p_scr = (
                np.empty(self._PATCH_CAP, np.int64),
                np.empty(self._PATCH_CAP, np.int64),
                np.empty(self._PATCH_CAP, np.int32),
                np.empty(self._PATCH_CAP, np.int32),
            )
            self._patch_scratch = p_scr
        n_new = ctypes.c_int64(0)
        row_next = ctypes.c_int64(int(n_rows))
        n_fused = ctypes.c_int64(0)
        n_copied = ctypes.c_int64(0)
        n_patches = ctypes.c_int64(0)
        assert rows.flags.c_contiguous and rows.dtype == np.int32
        if old_gen is not None:
            octx, ouid_rows, orows, orow_len, orow_u16, on_rows = old_gen
            assert orows.flags.c_contiguous and orows.dtype == np.int32
            old_args = (
                octx._ctx,
                ouid_rows.ctypes.data_as(ctypes.c_void_p),
                orows.ctypes.data_as(ctypes.c_void_p),
                orow_len.ctypes.data_as(ctypes.c_void_p),
                orow_u16.ctypes.data_as(ctypes.c_void_p),
                orows.shape[1],
                int(on_rows),
            )
        else:
            old_args = (None, None, None, None, None, 0, 0)
        rc = self._lib.tt_ctx_split_emit_batch(
            self._ctx,
            data,
            seg_start.ctypes.data_as(ctypes.c_void_p),
            seg_end.ctypes.data_as(ctypes.c_void_p),
            n_segs,
            nthreads,
            out_ids.ctypes.data_as(ctypes.c_void_p),
            seg_nt.ctypes.data_as(ctypes.c_void_p),
            seg_np.ctypes.data_as(ctypes.c_void_p),
            new_uid.ctypes.data_as(ctypes.c_void_p),
            new_start.ctypes.data_as(ctypes.c_void_p),
            new_end.ctypes.data_as(ctypes.c_void_p),
            cap,
            ctypes.byref(n_new),
            table.byte_to_id.ctypes.data_as(ctypes.c_void_p),
            table.key_left.ctypes.data_as(ctypes.c_void_p),
            table.key_right.ctypes.data_as(ctypes.c_void_p),
            table.values.ctypes.data_as(ctypes.c_void_p),
            table.slot_bits,
            table.max_probes,
            rows.ctypes.data_as(ctypes.c_void_p),
            row_len.ctypes.data_as(ctypes.c_void_p),
            row_u16.ctypes.data_as(ctypes.c_void_p),
            rows.shape[1],
            # row_cap gates ONLY the inline first-seen merge; 0 defers
            # every news to the wave path (device-route emit) while the
            # emit itself still reads already-resolved rows.
            rows.shape[0] if fuse else 0,
            uid_rows.ctypes.data_as(ctypes.c_void_p),
            len(uid_rows),
            ctypes.byref(row_next),
            ctypes.byref(n_fused),
            *old_args,
            ctypes.byref(n_copied),
            (
                ovf_pool.ctypes.data_as(ctypes.c_void_p)
                if ovf_pool is not None
                else None
            ),
            len(ovf_pool) if ovf_pool is not None else 0,
            p_scr[0].ctypes.data_as(ctypes.c_void_p),
            p_scr[1].ctypes.data_as(ctypes.c_void_p),
            p_scr[2].ctypes.data_as(ctypes.c_void_p),
            p_scr[3].ctypes.data_as(ctypes.c_void_p),
            self._PATCH_CAP,
            ctypes.byref(n_patches),
            _uid_ids_ptr(uid_ids, uid_rows),
        )
        # With fuse disabled, row_cap was passed as 0 purely to gate the
        # inline merge — the returned row_next is clamped to it and MUST
        # NOT be committed (wiping the caller's row high-water mark
        # would recycle resolved rows still referenced by uid_rows).
        committed_rows = int(row_next.value) if fuse else n_rows
        if rc == -6:
            # Patch scratch overflowed: the emit output is unusable but
            # the news arrays are valid (filled before the fixup), so
            # the caller can register + resolve the deferred pieces —
            # REQUIRED, every interned uid must end with a row — before
            # retrying through the classic path.
            k = n_new.value
            return (
                "patch_overflow",
                (
                    new_uid[:k].copy(),
                    new_start[:k].copy(),
                    new_end[:k].copy(),
                ),
                committed_rows,
            )
        if rc < 0:
            raise RuntimeError(_errmsg("tt_ctx_split_emit_batch", rc))
        k = n_new.value
        news = (
            new_uid[:k].copy(),
            new_start[:k].copy(),
            new_end[:k].copy(),
        )
        npz = n_patches.value
        patches = (
            p_scr[0][:npz].copy(),
            p_scr[1][:npz].copy(),
            p_scr[2][:npz].copy(),
            p_scr[3][:npz].copy(),
        )
        offsets = seg_start - base
        return (
            out_ids,
            offsets,
            seg_nt,
            seg_np,
            news,
            committed_rows,
            int(n_fused.value),
            int(n_copied.value),
            patches,
        )

    def lookup_spans(
        self, blob, starts: np.ndarray, ends: np.ndarray
    ) -> np.ndarray:
        """Probe-only batched lookup: uid of each span, -1 when absent.

        Valid on a FROZEN context (no concurrent inserts) — used to
        resurrect retired-generation rows during generational dedup
        eviction.  Never interns anything.
        """
        n = len(starts)
        out = np.empty(n, dtype=np.int32)
        if n == 0:
            return out
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        ends = np.ascontiguousarray(ends, dtype=np.int64)
        self._lib.tt_ctx_lookup_spans(
            self._ctx,
            blob,
            starts.ctypes.data_as(ctypes.c_void_p),
            ends.ctypes.data_as(ctypes.c_void_p),
            n,
            len(blob),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out


def bpe_encode(piece: bytes, table) -> np.ndarray:
    """Exact tiktoken byte-pair merge of one piece via the pair table.

    ``table`` is an :class:`~tokenizer_tpu.ops.pair_table.PairTable`;
    output is bit-identical to :func:`tokenizer_tpu.bpe.byte_pair_encode`
    (differentially tested) at O(n log n) — the host fallback for
    pieces longer than the widest device bucket.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native bpe unavailable")
    n = len(piece)
    out = np.empty(max(n, 1), dtype=np.int32)
    w = lib.tt_bpe_encode(
        piece,
        n,
        table.byte_to_id.ctypes.data_as(ctypes.c_void_p),
        table.key_left.ctypes.data_as(ctypes.c_void_p),
        table.key_right.ctypes.data_as(ctypes.c_void_p),
        table.values.ctypes.data_as(ctypes.c_void_p),
        table.slot_bits,
        table.max_probes,
        out.ctypes.data_as(ctypes.c_void_p),
        len(out),
    )
    if w < 0:
        raise RuntimeError(f"tt_bpe_encode failed: {w}")
    return out[:w]


def bpe_encode_batch_spans(
    buf,
    starts: np.ndarray,
    ends: np.ndarray,
    table,
    whole_ids: Optional[np.ndarray] = None,
    nthreads: int = 0,
):
    """Batched exact merge of scattered spans in ONE native call.

    Piece i is ``buf[starts[i]:ends[i]]``; returns
    ``(out, out_offs, counts)`` with piece i's ids at
    ``out[out_offs[i] : out_offs[i] + counts[i]]``.  ``whole_ids``
    (int32, -1 = no hit) optionally short-circuits whole-piece encoder
    hits; omitting it is exact whenever unreachable tokens were
    filtered upstream (merging a reachable vocab token reproduces its
    id).  Per-thread merge scratch is reused across pieces — the
    per-call allocation cost that made one-ctypes-call-per-piece
    ~100 us/piece.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native bpe unavailable")
    if nthreads <= 0:
        nthreads = default_threads()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out_offs = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum(ends - starts, out=out_offs[1:])
    out = np.empty(max(int(out_offs[-1]), 1), dtype=np.int32)
    counts = np.zeros(max(n, 1), dtype=np.int32)
    wi_ptr = None
    if whole_ids is not None:
        whole_ids = np.ascontiguousarray(whole_ids, dtype=np.int32)
        wi_ptr = whole_ids.ctypes.data_as(ctypes.c_void_p)
    rc = lib.tt_bpe_encode_batch(
        buf,
        starts.ctypes.data_as(ctypes.c_void_p),
        ends.ctypes.data_as(ctypes.c_void_p),
        out_offs.ctypes.data_as(ctypes.c_void_p),
        n,
        wi_ptr,
        table.byte_to_id.ctypes.data_as(ctypes.c_void_p),
        table.key_left.ctypes.data_as(ctypes.c_void_p),
        table.key_right.ctypes.data_as(ctypes.c_void_p),
        table.values.ctypes.data_as(ctypes.c_void_p),
        table.slot_bits,
        table.max_probes,
        nthreads,
        out.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
    )
    if rc < 0:
        raise RuntimeError(f"tt_bpe_encode_batch failed: {rc}")
    return out, out_offs[:-1], counts[:n]


def bpe_encode_batch(
    pieces,
    table,
    whole_ids: Optional[np.ndarray] = None,
    nthreads: int = 0,
):
    """List-of-bytes convenience wrapper over
    :func:`bpe_encode_batch_spans` (concatenates the pieces)."""
    n = len(pieces)
    blob = b"".join(pieces)
    offs = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum([len(p) for p in pieces], out=offs[1:])
    return bpe_encode_batch_spans(
        blob, offs[:-1], offs[1:], table, whole_ids=whole_ids,
        nthreads=nthreads,
    )


def gather_bytes(
    blob: np.ndarray,
    offsets: np.ndarray,
    ids: np.ndarray,
    total: int,
) -> bytes:
    """Concatenate blob[offsets[id]:offsets[id+1]] over ids (skip unknown)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native presplit unavailable")
    out = np.empty(total, dtype=np.uint8)
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    w = lib.tt_gather_bytes(
        blob.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        len(offsets) - 1,
        ids.ctypes.data_as(ctypes.c_void_p),
        len(ids),
        out.ctypes.data_as(ctypes.c_void_p),
        total,
    )
    if w < 0:
        raise RuntimeError("tt_gather_bytes overflow")
    return out[:w].tobytes()


def gather_bytes_batch(
    blob: np.ndarray,
    offsets: np.ndarray,
    ids: np.ndarray,
    id_bounds: np.ndarray,
    nthreads: int = 0,
):
    """Whole-batch id -> bytes gather for decode_batch.

    ``ids`` is the concatenation of every text's ids; text t spans
    ``ids[id_bounds[t]:id_bounds[t+1]]``.  Returns ``(raw, text_offs)``
    where text t's bytes are ``raw[text_offs[t]:text_offs[t+1]]``.
    Unknown ids are skipped (reference decode semantics).  Two native
    phases (sizes, threaded copy); no Python-side per-id passes.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native presplit unavailable")
    if nthreads <= 0:
        nthreads = default_threads()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    id_bounds = np.ascontiguousarray(id_bounds, dtype=np.int64)
    n_texts = len(id_bounds) - 1
    text_offs = np.zeros(n_texts + 1, dtype=np.int64)
    args = (
        blob.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        len(offsets) - 1,
        ids.ctypes.data_as(ctypes.c_void_p),
        id_bounds.ctypes.data_as(ctypes.c_void_p),
        n_texts,
        nthreads,
        text_offs.ctypes.data_as(ctypes.c_void_p),
    )
    total = lib.tt_gather_bytes_batch(*args, None, 0)
    np.cumsum(text_offs, out=text_offs)  # n_texts+1 elements: cheap
    out = np.empty(max(int(total), 1), dtype=np.uint8)
    w = lib.tt_gather_bytes_batch(
        *args, out.ctypes.data_as(ctypes.c_void_p), int(total)
    )
    if w < 0:
        raise RuntimeError("tt_gather_bytes_batch overflow")
    return out[:w], text_offs


def backfill_patches(
    out_ids: np.ndarray,
    seg_offs: np.ndarray,
    seg_nt: np.ndarray,
    patches,
    rows: np.ndarray,
    row_len: np.ndarray,
    uid_rows: np.ndarray,
    ovf_pool: Optional[np.ndarray] = None,
) -> None:
    """Splice resolved rows into emit HOLES in place and close the
    reserved gaps (tt_backfill_patches); updates seg_nt in place."""
    p_seg, p_pos, p_uid, p_res = patches
    n = len(p_seg)
    if n == 0:
        return
    lib = _load()
    p_seg = np.ascontiguousarray(p_seg, dtype=np.int64)
    p_pos = np.ascontiguousarray(p_pos, dtype=np.int64)
    p_uid = np.ascontiguousarray(p_uid, dtype=np.int32)
    p_res = np.ascontiguousarray(p_res, dtype=np.int32)
    seg_offs = np.ascontiguousarray(seg_offs, dtype=np.int64)
    rc = lib.tt_backfill_patches(
        out_ids.ctypes.data_as(ctypes.c_void_p),
        seg_offs.ctypes.data_as(ctypes.c_void_p),
        seg_nt.ctypes.data_as(ctypes.c_void_p),
        p_seg.ctypes.data_as(ctypes.c_void_p),
        p_pos.ctypes.data_as(ctypes.c_void_p),
        p_uid.ctypes.data_as(ctypes.c_void_p),
        p_res.ctypes.data_as(ctypes.c_void_p),
        n,
        rows.ctypes.data_as(ctypes.c_void_p),
        row_len.ctypes.data_as(ctypes.c_void_p),
        rows.shape[1],
        uid_rows.ctypes.data_as(ctypes.c_void_p),
        ovf_pool.ctypes.data_as(ctypes.c_void_p)
        if ovf_pool is not None
        else None,
    )
    if rc < 0:
        raise RuntimeError(
            "tt_backfill_patches: unresolved uid in patch set"
        )


def count_batch(
    rows: np.ndarray,
    row_len: np.ndarray,
    uid_rows: Optional[np.ndarray],
    uid_buf: np.ndarray,
    seg_offs: np.ndarray,
    seg_counts: np.ndarray,
    nthreads: int = 0,
    ovf_pool: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-segment token TOTALS only (tt_assemble_batch phase 1): the
    threaded uid->row->row_len count pass without materializing any
    ids — the bulk-trim budget bookkeeping's total source."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native presplit unavailable")
    if nthreads <= 0:
        nthreads = default_threads()
    n_segs = len(seg_counts)
    seg_offs = np.ascontiguousarray(seg_offs, dtype=np.int64)
    seg_counts = np.ascontiguousarray(seg_counts, dtype=np.int64)
    totals = np.empty(n_segs, dtype=np.int64)
    grand = lib.tt_assemble_batch(
        rows.ctypes.data_as(ctypes.c_void_p),
        row_len.ctypes.data_as(ctypes.c_void_p),
        rows.shape[1],
        uid_rows.ctypes.data_as(ctypes.c_void_p)
        if uid_rows is not None
        else None,
        uid_buf.ctypes.data_as(ctypes.c_void_p),
        seg_offs.ctypes.data_as(ctypes.c_void_p),
        seg_counts.ctypes.data_as(ctypes.c_void_p),
        n_segs,
        nthreads,
        totals.ctypes.data_as(ctypes.c_void_p),
        None,
        None,
        0,
        ovf_pool.ctypes.data_as(ctypes.c_void_p)
        if ovf_pool is not None
        else None,
    )
    if grand < 0:
        raise RuntimeError(f"tt_assemble_batch count failed: {grand}")
    return totals


def assemble_batch(
    rows: np.ndarray,
    row_len: np.ndarray,
    uid_rows: Optional[np.ndarray],
    uid_buf: np.ndarray,
    seg_offs: np.ndarray,
    seg_counts: np.ndarray,
    nthreads: int = 0,
    ovf_pool: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-call parallel token-stream assembly for a whole batch.

    Returns ``(out, out_offs, totals)``: segment k's ids are
    ``out[out_offs[k] : out_offs[k] + totals[k]]``.  Overflow rows
    (``row_len[r] == -(k+1)`` with the pool offset in ``rows[r, 0]``)
    assemble natively when ``ovf_pool`` is given; without a pool,
    ``totals[k] == -1`` marks such segments for the caller's slow path.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native presplit unavailable")
    if nthreads <= 0:
        nthreads = default_threads()
    n_segs = len(seg_counts)
    seg_offs = np.ascontiguousarray(seg_offs, dtype=np.int64)
    seg_counts = np.ascontiguousarray(seg_counts, dtype=np.int64)
    totals = np.empty(n_segs, dtype=np.int64)
    ur_ptr = (
        uid_rows.ctypes.data_as(ctypes.c_void_p) if uid_rows is not None else None
    )
    pool_ptr = (
        ovf_pool.ctypes.data_as(ctypes.c_void_p) if ovf_pool is not None else None
    )
    grand = lib.tt_assemble_batch(
        rows.ctypes.data_as(ctypes.c_void_p),
        row_len.ctypes.data_as(ctypes.c_void_p),
        rows.shape[1],
        ur_ptr,
        uid_buf.ctypes.data_as(ctypes.c_void_p),
        seg_offs.ctypes.data_as(ctypes.c_void_p),
        seg_counts.ctypes.data_as(ctypes.c_void_p),
        n_segs,
        nthreads,
        totals.ctypes.data_as(ctypes.c_void_p),
        None,
        None,
        0,
        pool_ptr,
    )
    if grand < 0:
        raise RuntimeError(f"tt_assemble_batch phase1 failed: {grand}")
    out_offs = np.zeros(n_segs, dtype=np.int64)
    if n_segs:
        np.cumsum(np.maximum(totals[:-1], 0), out=out_offs[1:])
    out = np.empty(grand, dtype=np.int32)
    w = lib.tt_assemble_batch(
        rows.ctypes.data_as(ctypes.c_void_p),
        row_len.ctypes.data_as(ctypes.c_void_p),
        rows.shape[1],
        ur_ptr,
        uid_buf.ctypes.data_as(ctypes.c_void_p),
        seg_offs.ctypes.data_as(ctypes.c_void_p),
        seg_counts.ctypes.data_as(ctypes.c_void_p),
        n_segs,
        nthreads,
        totals.ctypes.data_as(ctypes.c_void_p),
        out_offs.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        grand,
        pool_ptr,
    )
    if w < 0:
        raise RuntimeError(f"tt_assemble_batch phase2 failed: {w}")
    return out, out_offs, totals


