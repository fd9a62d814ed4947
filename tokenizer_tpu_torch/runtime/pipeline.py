"""Corpus encoding pipeline: chunked, resumable, shard-parallel.

The port's copy of :mod:`tokenizer_tpu.runtime.pipeline`, with its
output files, manifest, digest sidecar and resume checks unchanged.
The one difference: the default shard comes from the port's
:func:`~tokenizer_tpu_torch.parallel.multihost.process_info`
(torch.distributed or torchrun's environment), and an error there
propagates instead of turning into shard 0 of 1.

The production bulk path for the BASELINE corpus configs (1 GB+ shard
encode, multi-host data parallelism):

* documents stream in and are grouped into ~``chunk_bytes`` batches;
* each chunk runs through :meth:`GpuTokenizer.encode_batch_stream`
  (native split + device merge) and is written as ``tokens_NNNNNN.npz``
  (flat int32 ids + per-document offsets — order-preserving);
* a per-shard JSON manifest records completed chunks and counters, so
  a preempted job resumes exactly where it stopped (SURVEY.md §5
  checkpoint/resume: tokenization is stateless, chunk-level retry
  suffices — vocab tables are immutable inputs and never checkpointed);
* shards are document-interleaved (doc k belongs to shard k % n), so
  multi-host output order is restored by stable (shard, chunk, doc)
  indices; shards never exchange token data (SURVEY.md §2.3).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ShardProgress", "encode_corpus", "iter_corpus_files"]

#: bytes asked of each ``os.read``; a file is read until one returns none.
_READ_BYTES = 1 << 20


def corpus_files(root: str) -> List[str]:
    """The files under directory ``root``, in the order of
    ``sorted(f for f in Path(root).rglob("*") if f.is_file())``, from one
    ``os.scandir`` per directory and no ``stat`` for a regular file (the
    directory entry's type says what it is).

    The order is how ``Path`` objects compare, part by part: ``a/x``
    before ``a-b/x``, though as strings it is the other way round.  As
    ``rglob`` does, the walk skips a directory it cannot list and never
    enters a symlink to a directory; a symlink is a file when its
    target is one.
    """
    files, dirs = [], [((), root)]
    while dirs:
        parts, d = dirs.pop()
        try:
            with os.scandir(d) as it:
                entries = list(it)
        except OSError:
            continue
        for e in entries:
            key = (*parts, e.name)
            try:
                is_dir = e.is_dir(follow_symlinks=False)
            except OSError:
                is_dir = False
            if is_dir:
                dirs.append((key, e.path))
                continue
            try:
                is_file = e.is_file()
            except OSError:  # rglob's own test decides: False or raise
                is_file = Path(e.path).is_file()
            if is_file:
                files.append((key, e.path))
    files.sort()
    return [f for _, f in files]


def read_text(path: str) -> str:
    """The file's text as ``Path.read_text(encoding="utf-8",
    errors="replace")`` gives it, from ``open``, ``read`` until a read
    returns no bytes (a short read is not the end on FUSE or network
    filesystems) and ``close``: no ``fstat``, ``ioctl`` or ``lseek``.
    Newlines are translated as text mode does; a BOM stays."""
    fd = os.open(path, os.O_RDONLY | os.O_CLOEXEC)
    try:
        chunks = []
        while chunk := os.read(fd, _READ_BYTES):
            chunks.append(chunk)
    finally:
        os.close(fd)
    text = b"".join(chunks).decode("utf-8", "replace")
    if "\r" in text:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
    return text


def iter_corpus_files(
    paths: Sequence[str], on_skip=None
) -> Iterator[str]:
    """Yield document texts from files/directories (utf-8, replace).

    The documents and their order are the JAX package's; the walk is
    :func:`corpus_files` and each file is read by :func:`read_text` when
    its document is asked for.

    An unreadable file is NEVER skipped silently: because documents are
    assigned to shards positionally (doc k -> shard k % n_shards), a
    vanished file would shift every later document's shard assignment
    and silently re-align resume digests to a different stream.  By
    default an :class:`OSError` propagates (fail loud).  Pass an
    ``on_skip(path, exc)`` callable to opt into skipping — the callable
    is invoked for every skipped file so the caller can count/log them
    and fold the skip set into its resume contract.
    """
    for p in paths:
        path = Path(p)
        files = corpus_files(str(path)) if path.is_dir() else [str(path)]
        for f in files:
            try:
                text = read_text(f)
            except OSError as e:
                if on_skip is None:
                    raise OSError(
                        f"unreadable corpus file {Path(f)}: {e}; skipping would"
                        f" silently shift shard assignment of every later"
                        f" document (pass on_skip=... to opt in)"
                    ) from e
                on_skip(Path(f), e)
                continue
            yield text


@dataclass
class ShardProgress:
    """Manifest state for one shard (JSON-serialized next to outputs)."""

    shard: int
    n_shards: int
    chunks_done: int = 0
    docs: int = 0
    bytes_in: int = 0
    tokens_out: int = 0
    seconds: float = 0.0
    #: per-chunk corpus fingerprints (blake2b of the chunk's documents,
    #: hex).  Resume recomputes each skipped chunk's digest and refuses
    #: to continue on mismatch, so a corpus that changed between runs
    #: fails loudly instead of silently producing misaligned output.
    #: Rewinding ``chunks_done`` stays valid: only the skipped prefix is
    #: checked, and re-run chunks overwrite their entry.  Persisted as
    #: an APPEND-ONLY sidecar ("<idx> <digest>" lines) next to the
    #: manifest, NOT in the manifest JSON — rewriting a growing list
    #: every chunk would make total manifest I/O quadratic in chunk
    #: count (a 1 TB shard is ~125k chunks).
    chunk_digests: List[str] = field(default_factory=list)

    @staticmethod
    def digest_path(manifest_path: Path) -> Path:
        return manifest_path.with_suffix(".digests")

    @classmethod
    def load(cls, path: Path) -> Optional["ShardProgress"]:
        try:
            state = json.loads(path.read_text())
        except (OSError, ValueError):
            return None
        digests = state.pop("chunk_digests", [])  # legacy manifests
        try:
            prog = cls(**state)
        except TypeError:
            return None
        prog.chunk_digests = list(digests)
        try:
            for line in cls.digest_path(path).read_text().splitlines():
                idx, _, d = line.partition(" ")
                i = int(idx)
                prog.chunk_digests.extend(
                    [""] * (i + 1 - len(prog.chunk_digests))
                )
                prog.chunk_digests[i] = d
        except (OSError, ValueError):
            pass
        return prog

    def save(self, path: Path) -> None:
        state = dict(self.__dict__)
        state.pop("chunk_digests")
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state))
        os.replace(tmp, path)

    def append_digest(self, path: Path, ci: int, digest: str) -> None:
        """Record chunk ci's digest (in memory + sidecar append)."""
        self.chunk_digests.extend([""] * (ci + 1 - len(self.chunk_digests)))
        self.chunk_digests[ci] = digest
        with open(self.digest_path(path), "a") as f:
            f.write(f"{ci} {digest}\n")


def _chunk_digest(batch: Sequence[str]) -> str:
    """Order-sensitive digest of one chunk's documents (hex)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for doc in batch:
        b = doc.encode("utf-8", "surrogatepass")
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return h.hexdigest()


def _chunks(
    docs: Iterable[str], chunk_bytes: int, shard: int, n_shards: int
) -> Iterator[List[str]]:
    batch: List[str] = []
    size = 0
    for k, doc in enumerate(docs):
        if k % n_shards != shard:
            continue
        batch.append(doc)
        size += len(doc)
        if size >= chunk_bytes:
            yield batch
            batch, size = [], 0
    if batch:
        yield batch


def encode_corpus(
    docs: Iterable[str],
    tokenizer,
    out_dir: str,
    chunk_bytes: int = 8 << 20,
    shard: Optional[int] = None,
    n_shards: Optional[int] = None,
    allowed_special=None,
    write_tokens: bool = True,
    resume: bool = True,
) -> ShardProgress:
    """Encode a document stream into per-chunk token files + manifest.

    ``shard``/``n_shards`` default to this process's rank and the world
    size of the torch.distributed job (1 process -> single shard).
    Returns the final progress record; counters across shards can be
    reduced with :func:`tokenizer_tpu_torch.parallel.multihost.all_sum`.
    """
    if shard is None or n_shards is None:
        from ..parallel.multihost import process_info

        # Backend-free when single-process.  No fallback: a rank that
        # guessed "shard 0 of 1" would encode every other rank's shard.
        shard, n_shards = process_info()

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest_path = out / f"manifest_shard{shard:05d}.json"
    progress = (
        (ShardProgress.load(manifest_path) if resume else None)
        or ShardProgress(shard=shard, n_shards=n_shards)
    )
    if not resume:
        ShardProgress.digest_path(manifest_path).unlink(missing_ok=True)
    if progress.n_shards != n_shards or progress.shard != shard:
        raise ValueError(
            f"manifest {manifest_path} was written for shard "
            f"{progress.shard}/{progress.n_shards}, not {shard}/{n_shards}"
        )

    # Eagerly skip + verify the already-done prefix so resume
    # verification (re-reading and hashing potentially GBs of skipped
    # documents) never lands in the timed region of the first new chunk.
    chunk_iter = enumerate(_chunks(docs, chunk_bytes, shard, n_shards))
    first_new: Optional[Tuple[int, List[str]]] = None
    for ci, batch in chunk_iter:
        if ci >= progress.chunks_done:
            first_new = (ci, batch)
            break
        # The chunk is already durable, but verify the doc stream is
        # byte-identical to the producing run.  Empty entries (manifests
        # predating the digest sidecar, or gaps after a rewind) carry no
        # information and are skipped, never treated as a mismatch.
        digest = _chunk_digest(batch)
        recorded = (
            progress.chunk_digests[ci]
            if ci < len(progress.chunk_digests)
            else ""
        )
        if recorded and recorded != digest:
            raise ValueError(
                f"corpus fingerprint mismatch on resume: chunk {ci} "
                f"of manifest {manifest_path} was written for a "
                f"different document stream (recorded {recorded}, "
                f"replayed {digest}); refusing to continue"
            )

    pending: List[Tuple[int, List[str]]] = []

    def _batches() -> Iterator[List[str]]:
        if first_new is not None:
            pending.append(first_new)
            yield first_new[1]
        for ci, batch in chunk_iter:
            pending.append((ci, batch))
            yield batch

    # Pipelined when the tokenizer supports it (GpuTokenizer): the host
    # splits chunk k+1 while the device merges chunk k.  Tokenizers
    # without bulk APIs (the host engine, e.g. `corpus --no-gpu`) fall
    # back to per-document encode.
    if hasattr(tokenizer, "encode_batch_stream"):
        stream = tokenizer.encode_batch_stream(_batches(), allowed_special)
    elif hasattr(tokenizer, "encode_batch"):
        stream = (
            tokenizer.encode_batch(b, allowed_special) for b in _batches()
        )
    else:
        stream = (
            [
                np.asarray(tokenizer.encode(t, allowed_special), dtype=np.int32)
                for t in b
            ]
            for b in _batches()
        )

    t0 = time.perf_counter()
    for ids_list in stream:
        ci, batch = pending.pop(0)
        if write_tokens:
            flat = (
                np.concatenate(ids_list)
                if ids_list
                else np.empty(0, np.int32)
            )
            offsets = np.zeros(len(ids_list) + 1, dtype=np.int64)
            np.cumsum([len(x) for x in ids_list], out=offsets[1:])
            fname = out / f"tokens_s{shard:05d}_c{ci:06d}.npz"
            tmp = out / f".tmp_s{shard:05d}_c{ci:06d}.npz"
            np.savez(tmp, ids=flat, offsets=offsets)
            os.replace(tmp, fname)
        progress.seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        progress.docs += len(batch)
        progress.bytes_in += sum(
            len(d.encode("utf-8", "ignore")) for d in batch
        )
        progress.tokens_out += int(sum(len(x) for x in ids_list))
        progress.chunks_done = ci + 1
        progress.append_digest(manifest_path, ci, _chunk_digest(batch))
        progress.save(manifest_path)
    return progress
