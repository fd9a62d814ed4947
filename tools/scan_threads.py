#!/usr/bin/env python3
"""The native scan's thread curve, warm and cold, and the parts of the stream's scan span.

    python3 tools/scan_threads.py [--mb 8] [--seed 0] [--cycles 5] [--device cuda] [--out FILE]

On ``chip_smoke.gen_corpus(mb, seed)`` as one buffer of documents, each
time the best of ``--cycles`` runs (``bench.py`` ``scan_threads_bench``):

1. the pure scan: ``native.presplit`` over the whole buffer, one thread,
   no interning;
2. ``SplitContext.split_batch`` (scan and intern, every piece seen
   before) at 1, 2, 4 and 8 threads; its uids must be the same at every
   count;
3. ``split_emit_batch`` (scan, intern and id emit) at 1, 2, 4 and 8
   threads, on a cl100k_synth ``GpuTokenizer`` on ``--device`` whose
   every row was first resolved through the host route, so no piece is
   new; every document's ids must equal Rust tiktoken's;
4. at the native calls' default thread count (``default_threads()``),
   ``GpuTokenizer._build_segments`` (the documents into one buffer, in
   Python) apart from ``split_emit_batch``: the two parts of the
   ``_native_encode_emit`` span that ``bench_torch.py`` traces, beside
   one whole warm ``encode_batch`` of the documents;
5. cold: ``split_emit_batch`` over the documents in the stream cell's
   chunks (its ``chunk_docs`` in ``BENCHMARK.json``), in turn, on a fresh
   cl100k_synth tokenizer each run (nothing interned, no row), fused
   (first-seen pieces merged on the scanning threads, the host route's
   scan) and unfused (every first-seen piece deferred, the device
   route's scan), at 1, 2, 4 and 8 threads, ``--cycles`` runs each: each
   run's wall beside the scanner's counters
   (``runtime.native.SCAN_COUNTERS``: interning, fused merges by class,
   deferred news, holes, worker time); after each call the news are
   resolved on the host and the holes backfilled, untimed, and every
   document's ids are held to Rust tiktoken;
6. fresh: on a new ``SplitContext``, ``split_batch`` of the first 16
   documents twice, at 1, 2, 4 and 8 threads, the best of ``--cycles``
   contexts: the first call's wall (``call_s``) holds the context's
   per-worker set-up and the pieces' first sight, the second call's
   neither.

The scan runs on the host; the tokenizer sits on ``--device`` (the card
by default, ``--device cpu`` without one).  It prints one JSON record
and writes it to ``--out`` with the card's name and power limit.  jax,
the JAX package and ``bench.py`` are never imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THREADS = (1, 2, 4, 8)


def best_s(fn, cycles: int) -> float:
    """The shortest of ``cycles`` timed calls of ``fn``, in seconds."""
    best = float("inf")
    for _ in range(cycles):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure(mb: float, seed: int, cycles: int, device: str) -> dict:
    import numpy as np

    import tokenizer_tpu_torch as tt
    from bench_torch import check, load_benchmark, reference_ids, seed_text
    from chip_smoke import gen_corpus
    from tokenizer_tpu_torch.runtime import native

    (stream,) = [w for w in load_benchmark()["workloads"] if w["entry"] == "encode_batch_stream"]
    chunk_docs = stream["chunk_docs"]
    docs = gen_corpus(mb, seed, seed_text())
    datas = [d.encode("utf-8") for d in docs]
    buf = b"".join(datas)
    ends = np.cumsum([len(d) for d in datas], dtype=np.int64)
    starts = ends - np.array([len(d) for d in datas], dtype=np.int64)
    n = len(buf)
    want = reference_ids("cl100k_synth", docs)

    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device, mesh=None)
    tok._host_wave_max = sys.maxsize  # every row through the host route
    tok._ensure_device()
    pid = tok._native_pid
    pure = best_s(lambda: native.presplit(buf, pid), cycles)

    ctx = native.SplitContext(pid)

    def split_uids(threads: int):
        """Every document's piece uids, in order, and the pieces first seen."""
        uid, offs, counts, news = ctx.split_batch(buf, starts, ends, nthreads=threads)
        return np.concatenate([uid[o : o + c] for o, c in zip(offs, counts)]), len(news[0])

    uids, _ = split_uids(1)  # interns every piece
    split = []
    for t in THREADS:
        split.append({"threads": t, "MBps": n / best_s(
            lambda: ctx.split_batch(buf, starts, ends, nthreads=t), cycles) / 1e6})
        got, new = split_uids(t)
        check(np.array_equal(got, uids) and new == 0,
              f"split_batch at {t} threads: uids differ from one thread's")

    got = tok.encode_batch(docs)  # resolves every row
    check(all(np.array_equal(g, w) for g, w in zip(got, want)) and len(got) == len(want),
          "the host-routed encode_batch differs from tiktoken")
    allowed = tok._resolve_allowed(None)

    def emit(threads: int):
        return tok._split_ctx.split_emit_batch(
            buf, starts, ends, tok.table, tok._rows, tok._row_len, tok._row_u16, tok._uid_rows,
            tok._n_rows, ovf_pool=tok._ovf_pool, nthreads=threads, old_gen=tok._old_gen_native(),
            fuse=False, uid_ids=tok._uid_ids)

    def emit_exact(threads: int) -> None:
        ids, offs, counts, _, news, n_rows, _, _, patches = emit(threads)
        check(not len(news[0]) and not len(patches[0]) and n_rows == tok._n_rows,
              f"split_emit_batch at {threads} threads met a piece without a row")
        for i, w in enumerate(want):
            check(np.array_equal(ids[offs[i] : offs[i] + counts[i]], w),
                  f"split_emit_batch at {threads} threads: document {i} differs from tiktoken")

    points = []
    for t in THREADS:
        points.append({"threads": t, "MBps": n / best_s(lambda: emit(t), cycles) / 1e6})
        emit_exact(t)
    default = native.default_threads()
    head = slice(0, 16)
    hbuf, hs, he = b"".join(datas[head]), starts[head] - starts[0], ends[head] - starts[0]
    fresh = []
    for t in THREADS:
        calls = [[], []]
        for _ in range(cycles):
            fctx = native.SplitContext(pid)
            for out in calls:
                c = native.scan_counters()
                fctx.split_batch(hbuf, hs, he, nthreads=t, counters=c)
                out.append(native.scan_report(c)["call_s"])
        fresh.append({"threads": t, "first_call_s": min(calls[0]), "second_call_s": min(calls[1])})
    k = chunk_docs
    chunks = [(b"".join(datas[i : i + k]), starts[i : i + k] - starts[i], ends[i : i + k] - starts[i],
               want[i : i + k]) for i in range(0, len(docs), k)]
    cold = {"chunk_docs": k, "fused": [], "unfused": []}
    for t in THREADS:
        for arm in ("fused", "unfused"):
            runs = [cold_run(chunks, t, arm == "fused", device) for _ in range(cycles)]
            cold[arm].append({"threads": t, "best_wall_s": min(r["wall_s"] for r in runs),
                              "runs": runs})
    return {
        "bytes": n, "docs": len(docs), "seed": seed, "cycles": cycles, "device": device,
        "cpu_count": os.cpu_count(),
        "pure_scan_MBps": n / pure / 1e6,
        "split_points": split,
        "emit_points": points,
        "default_threads": default,
        "build_segments_s": best_s(lambda: tok._build_segments(docs, allowed), cycles),
        "split_emit_s": best_s(lambda: emit(default), cycles),
        "encode_batch_warm_s": best_s(lambda: tok.encode_batch(docs), cycles),
        "cold": cold,
        "fresh": {"docs": len(hs), "points": fresh},
    }


def cold_run(chunks: list, threads: int, fuse: bool, device: str) -> dict:
    """One cold pass of ``split_emit_batch`` over ``chunks`` ((buffer,
    starts, ends, tiktoken's ids) of each chunk of documents), in turn, on
    a fresh tokenizer (fused: its rows reserved as ``_native_encode_emit``
    reserves them): the calls' wall and the scanner's counters.  After
    each call, untimed, the news are resolved on the host and the holes
    backfilled, and the ids must equal tiktoken's.  A call whose holes
    overflow the patch buffer (``patch_overflow``, where the tokenizer
    falls back to its classic path) is counted, and the chunk emitted
    again, uncounted, once its news have rows."""
    import numpy as np

    import tokenizer_tpu_torch as tt
    from bench_torch import check
    from tokenizer_tpu_torch.runtime import native

    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device, mesh=None)
    tok._host_wave_max = sys.maxsize  # the news resolve on the host, after each timed call
    tok._split_ctx = native.SplitContext(tok._native_pid)
    counters = native.scan_counters()
    wall, overflows = 0.0, 0

    def resolve(news, buf):
        if len(news[0]):
            wave = tok._register_new_uids_arrays(news, buf)
            tok._finish_new_piece_rows(tok._dispatch_wave(wave))

    for ci, (buf, starts, ends, want) in enumerate(chunks):
        if fuse:
            tok._prepare_fused_capacity(len(buf))

        def emit(c):
            return tok._split_ctx.split_emit_batch(
                buf, starts, ends, tok.table, tok._rows, tok._row_len, tok._row_u16,
                tok._uid_rows, tok._n_rows, ovf_pool=tok._ovf_pool, nthreads=threads,
                fuse=fuse, uid_ids=tok._uid_ids, counters=c)

        t0 = time.perf_counter()
        res = emit(counters)
        wall += time.perf_counter() - t0
        if isinstance(res[0], str):  # ("patch_overflow", news, n_rows)
            overflows += 1
            tok._n_rows = res[2]
            resolve(res[1], buf)
            res = emit(None)
        ids, offs, counts, _, news, tok._n_rows, _, _, patches = res
        resolve(news, buf)
        tok._backfill_patches(ids, offs, counts, patches)
        for i, w in enumerate(want):
            check(np.array_equal(ids[offs[i] : offs[i] + counts[i]], w),
                  f"cold split_emit_batch at {threads} threads (fuse={fuse}): chunk {ci}, "
                  f"document {i} differs from tiktoken")
    report = native.scan_report(counters)
    outcomes = sum(report[k] for k in ("fused_short", "fused_long", "gen_copies", "defer_off",
                                       "defer_capacity", "defer_wide"))
    check(report["inserts"] == tok._split_ctx.n_pieces == outcomes,
          f"cold split_emit_batch at {threads} threads: the counters miss first-seen pieces")
    return {"wall_s": wall, "calls": len(chunks), "patch_overflows": overflows, "counters": report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "scan_threads.json")
    args = ap.parse_args(argv)
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(ROOT / "build" / "tokenizer_tpu_cache"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from ab_turns import smi

    record = measure(args.mb, args.seed, args.cycles, args.device)
    record["card"] = smi() if args.device.startswith("cuda") else "cpu (no card)"
    print(json.dumps(record), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
