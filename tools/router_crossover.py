#!/usr/bin/env python3
"""Where a first-seen piece merges cheapest: the host or the card, by its length.

    python3 tools/router_crossover.py [--mb 8] [--seed 0] [--rounds 3] [--device cuda]
                                      [--sizes 1,2,4,8,16,128,1024] [--pieces-only]
                                      [--out FILE]

On cl100k_synth and ``chip_smoke.gen_corpus(mb, seed)`` in the stream
cell's chunks (its ``chunk_docs`` in ``BENCHMARK.json``), it measures:

1. ``pieces``: the corpus's first-seen pieces by length class (``CLASSES``:
   <=16, 17-128, 129-512, 513-1,024 and 1,025-2,048 bytes), each class's
   ``wide`` count (pieces whose merge is wider than a row, ``gpu._MAX_OUT``
   ids: a fused merge of such a piece is thrown away and merged again on
   the news path), and the first chunk's and the whole pass's first-seen
   pieces per input byte (``--pieces-only``: this section alone); a
   class with fewer than ``TOP_UP`` pieces is topped up with CJK and
   letter runs of its lengths (``chip_smoke.synth_bucket_pieces``, each one
   regex piece), counted as ``synthesized``;
2. ``routings``: cold ``encode_batch_stream`` passes, each on a fresh
   tokenizer, ``--rounds`` rounds of the routings in turn: ``default``,
   ``host`` (``_host_wave_max = sys.maxsize``), ``card``
   (``chip_smoke.forced``), and ``host_one_call``, the host routing in one
   ``encode_batch`` of every document (``bench_torch.py``'s control), which
   tells chunking from routing.  Each pass: MB/s, split calls, the
   ``GpuTokenizer`` counters (``device_blocking_s``, waves, pieces by
   route), the seconds in ``_register_new_uids_arrays`` and
   ``_dispatch_device_spans``, K1 launches and the scanner's counters;
   every document's ids are held to Rust tiktoken;
3. ``host``: the host's cost of a first-seen piece per class, two ways:
   fused in the scan (``split_merge_batch`` on a fresh context over the
   class's pieces, each piece a segment, after one such call that warms
   the workers: the counters' fused merge seconds over the call's
   workers, per piece merged, and the share of pieces whose merge was
   wider than a row, which the news path merges again) and batched (the
   wave's route to the host, ``_host_wave_resolve_spans``: the native
   ``bpe_encode_batch_spans`` at ``default_threads()`` workers, at most
   one a piece, and the scatter into the rows; at ``--sizes`` pieces
   drawn with replacement, the rows registered untimed first);
4. ``device``: a device wave's blocking seconds per class at ``--sizes``
   pieces (pieces of the class drawn with replacement), through
   ``_register_new_uids_arrays``, ``_dispatch_device_spans`` and
   ``_finish_span_rows``, two ways: ``deferred`` (the card synchronized,
   untimed, between dispatch and finish, as a stream's next scan hides
   K1) and ``now`` (the finish at once, as ``encode_batch`` and the corpus
   take it, K1's time included);
   each route's points of at least ``FIT_MIN`` pieces are fitted by least
   squares to a part per wave and a part per piece; the smaller waves,
   whose host merge starts fewer workers, are kept as points;
5. ``crossover``: per class, the host's cost of fusing a piece (its
   merge in the scan; for the wide share, the registration and the
   batched merge too) beside the card's deferred cost per piece
   (registration, dispatch and finish), and ``L_host``, the longest class
   bound up to which the host is cheaper in every class; a wave's cost
   on each route, per wave and per piece, deferred and at once; and
   small waves: per class and way, the largest measured size up to which
   the host's wave costs no more than the card's at every measured size,
   and ``host_wave_max``, the threshold of the rule "a wave of at most so
   many pieces merges on the host" whose worst wrong decision over the
   classes above ``L_host``, deferred and at once, costs least
   (``regret_s``).

Medians over ``--rounds``.  It prints one JSON record and writes it to
``--out`` with the card's name and power limit.  jax, the JAX package
and ``bench.py`` are never imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the length classes, in bytes, both bounds inclusive.
CLASSES = ((1, 16), (17, 128), (129, 512), (513, 1024), (1025, 2048))
#: a wave's sizes, in pieces.
SIZES = (1, 2, 4, 8, 16, 128, 1024)
#: the fits per wave and per piece take the waves of at least this many
#: pieces (every host worker started).
FIT_MIN = 16
ROUTINGS = ("default", "host", "card", "host_one_call")
#: a class with fewer corpus pieces is topped up with synthesized runs.
TOP_UP = 256


def _median(xs: list) -> float:
    return statistics.median(xs) if xs else None


def fit(points: list) -> dict:
    """``(n, seconds)`` points of at least ``FIT_MIN`` pieces fitted to
    ``per_wave + n * per_piece``."""
    points = [(n, t) for n, t in points if n >= FIT_MIN] or points
    ns = [n for n, _ in points]
    ts = [t for _, t in points]
    mn, mt = statistics.fmean(ns), statistics.fmean(ts)
    var = sum((n - mn) ** 2 for n in ns)
    slope = sum((n - mn) * (t - mt) for n, t in zip(ns, ts)) / var if var else 0.0
    return {"per_wave_s": mt - slope * mn, "per_piece_s": slope}


def class_of(n: int):
    for c in CLASSES:
        if c[0] <= n <= c[1]:
            return c
    return None


def first_seen(tok, chunks: list, rng) -> dict:
    """The first-seen pieces of a cold pass over ``chunks`` (a fresh
    context, uid mode): their bytes by class, topped up to ``TOP_UP``,
    and the rates per byte."""
    import numpy as np

    from chip_smoke import synth_bucket_pieces
    from tokenizer_tpu_torch.runtime import native

    ctx = native.SplitContext(tok._native_pid)
    by_class = {c: [] for c in CLASSES}
    first_rate, total, nbytes = None, 0, 0
    for buf, starts, ends, _ in chunks:
        _, _, _, (uids, s, e) = ctx.split_batch(buf, starts, ends)
        if first_rate is None:
            first_rate = len(uids) / len(buf)
        total += len(uids)
        nbytes += len(buf)
        for a, b in zip(s.tolist(), e.tolist()):
            c = class_of(b - a)
            if c is not None:
                by_class[c].append(buf[a:b])
    lens = {c: [len(p) for p in ps] for c, ps in by_class.items()}
    wide = {c: wide_count(tok, ps) for c, ps in by_class.items()}
    synthesized = {}
    for (lo, hi), ps in by_class.items():
        top = []
        while len(ps) + len(top) < TOP_UP:
            # CJK and letter runs only: a digit run is not one regex piece.
            top += [p for p in synth_bucket_pieces(rng, lo - 1, hi, 3 * (TOP_UP - len(ps)))
                    if not p[:1].isdigit()]
        top = top[: max(TOP_UP - len(ps), 0)]
        synthesized[(lo, hi)] = len(top)
        ps += top
    return {
        "pieces": by_class,
        "report": {
            "first_chunk_per_byte": first_rate,
            "pass_per_byte": total / nbytes,
            "first_seen": total,
            "classes": [{"class": list(c), "pieces": len(ls), "bytes": int(np.sum(ls)) if ls else 0,
                         "wide": wide[c], "synthesized": synthesized[c]} for c, ls in lens.items()],
        },
    }


def wide_count(tok, pieces: list) -> int:
    """How many of ``pieces`` merge to more ids than a row holds."""
    from tokenizer_tpu_torch import gpu
    from tokenizer_tpu_torch.runtime import native

    if not pieces:
        return 0
    buf, starts, ends = spans_of(pieces)
    _, _, counts = native.bpe_encode_batch_spans(buf, starts, ends, tok.table)
    return int((counts > gpu._MAX_OUT).sum())


def spans_of(pieces: list):
    """``pieces`` as one buffer and their (starts, ends)."""
    import numpy as np

    lens = np.array([len(p) for p in pieces], dtype=np.int64)
    ends = np.cumsum(lens)
    return b"".join(pieces), ends - lens, ends


def fused_cost(tok, pieces: list, threads: int) -> dict:
    """One class's pieces merged in a scan (each a segment), on a fresh
    context whose workers a first call warmed."""
    import numpy as np

    from tokenizer_tpu_torch.runtime import native

    ctx = native.SplitContext(tok._native_pid)
    cap = len(pieces) + 2048
    rows = np.zeros((cap, tok._rows.shape[1]), np.int32)
    row_len = np.zeros(cap, np.int32)
    row_u16 = np.zeros(cap, np.int32)
    uid_rows = np.full(cap * 2, -1, np.int32)
    warm = [b" warm%d" % i for i in range(threads * 64)]
    n_rows = 0
    for batch in (warm, pieces):
        buf, starts, ends = spans_of(batch)
        c = native.scan_counters()
        t0 = time.perf_counter()
        _, _, _, _, n_rows, _, _ = ctx.split_merge_batch(
            buf, starts, ends, tok.table, rows, row_len, row_u16, uid_rows, n_rows,
            nthreads=threads, counters=c)
        wall = time.perf_counter() - t0
    r = native.scan_report(c)
    # A merge wider than a row defers after it ran: its time is counted.
    merged = r["fused_short"] + r["fused_long"] + r["defer_wide"]
    merge_s = r["fused_short_s"] + r["fused_long_s"]
    workers = r["workers"] / max(r["calls"], 1)
    return {
        "pieces": len(pieces),
        "fused_thread_s_per_piece": merge_s / max(merged, 1),
        "fused_workers": workers,
        "fused_s_per_piece": merge_s / max(merged, 1) / workers,
        "wide_share": r["defer_wide"] / max(merged, 1),
        "fused_call_s": wall,
    }


def batched_wave(tok, pieces: list, n: int, rng) -> float:
    """The blocking seconds of one host wave of ``n`` pieces drawn from
    ``pieces``, as the router's host route runs it: the batched native
    merge and the scatter into the rows, registered untimed first.  The
    tokenizer's rows are given back after."""
    import numpy as np

    pick = [pieces[i] for i in rng.integers(0, len(pieces), size=n)]
    buf, starts, ends = spans_of(pick)
    r0 = tok._n_rows
    rows, starts, ends, _, _ = tok._register_new_uids_arrays(
        (np.arange(n, dtype=np.int32), starts, ends), buf)
    t0 = time.perf_counter()
    tok._host_wave_resolve_spans(buf, starts, ends, rows)
    t1 = time.perf_counter()
    tok._n_rows = r0
    return t1 - t0


def device_wave(tok, pieces: list, n: int, rng, now: bool) -> dict:
    """One device wave of ``n`` pieces drawn from ``pieces``: the blocking
    seconds of its registration, dispatch and finish.  The tokenizer's
    rows are given back after."""
    import numpy as np

    pick = [pieces[i] for i in rng.integers(0, len(pieces), size=n)]
    buf, starts, ends = spans_of(pick)
    r0 = tok._n_rows
    uids = np.arange(n, dtype=np.int32)
    t0 = time.perf_counter()
    rows, starts, ends, _, _ = tok._register_new_uids_arrays((uids, starts, ends), buf)
    t1 = time.perf_counter()
    handle = tok._dispatch_device_spans(buf, rows, starts, ends)
    t2 = time.perf_counter()
    if not now and tok.device.type == "cuda":
        import torch

        torch.cuda.synchronize(tok.device)
    t3 = time.perf_counter()
    tok._finish_span_rows(handle)
    t4 = time.perf_counter()
    tok._n_rows = r0
    return {"register_s": t1 - t0, "wave_s": (t2 - t1) + (t4 - t3)}


def host_costs(tok, by_class: dict, rounds: int, rng, sizes, threads: int) -> list:
    out = []
    for c, pieces in by_class.items():
        runs = [fused_cost(tok, pieces, threads) for _ in range(rounds)]
        rec = {"class": list(c), **{k: _median([x[k] for x in runs]) for k in runs[0]}}
        points = [(n, _median([batched_wave(tok, pieces, n, rng) for _ in range(rounds)]))
                  for n in sizes]
        rec["batched"] = {"points": [{"n": n, "wave_s": t} for n, t in points], **fit(points)}
        out.append(rec)
    return out


def device_costs(tok, by_class: dict, rounds: int, rng, sizes) -> list:
    out = []
    for c, pieces in by_class.items():
        rec = {"class": list(c)}
        for way in ("deferred", "now"):
            points, reg = [], []
            for n in sizes:
                runs = [device_wave(tok, pieces, n, rng, way == "now") for _ in range(rounds)]
                wave_s = _median([x["wave_s"] for x in runs])
                points.append((n, wave_s))
                reg.append((n, _median([x["register_s"] for x in runs])))
            rec[way] = {"points": [{"n": n, "wave_s": t} for n, t in points], **fit(points)}
            rec[f"register_{way}"] = fit(reg)
        out.append(rec)
    return out


def routing_pass(routing: str, chunks: list, docs: list, want: list, device: str) -> dict:
    """One cold pass of a fresh tokenizer routed as ``routing``."""
    import numpy as np

    import tokenizer_tpu_torch as tt
    from bench_torch import check
    from chip_smoke import forced
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.runtime import native

    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device, mesh=None)
    if routing == "card":
        forced(tok)
    elif routing.startswith("host"):
        tok._host_wave_max = sys.maxsize
    tok._ensure_device()
    spent = {"_register_new_uids_arrays": 0.0, "_dispatch_device_spans": 0.0}

    def timed(name):
        fn = getattr(tok, name)

        def inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0

        return inner

    for name in spent:
        setattr(tok, name, timed(name))
    nbytes = sum(len(b) for b, _, _, _ in chunks)
    texts = [[docs[i] for i in range(lo, hi)] for lo, hi in chunk_bounds(chunks)]
    launches = merge_cuda.LAUNCHES
    t0 = time.perf_counter()
    if routing == "host_one_call":
        out = tok.encode_batch(docs)
    else:
        out = [ids for batch in tok.encode_batch_stream(texts) for ids in batch]
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = merge_cuda.LAUNCHES - launches
    check(len(out) == len(want) and all(np.array_equal(g, w) for g, w in zip(out, want)),
          f"routing {routing}: ids differ from tiktoken")
    st = tok.stats.as_dict()
    scan = native.scan_report(tok.stats.scan)
    return {
        "routing": routing,
        "MBps": nbytes / wall / 1e6,
        "wall_s": wall,
        "chunks": len(chunks) if routing != "host_one_call" else 1,
        "split_calls": scan["calls"],
        "k1_launches": launches,
        **{k: st[k] for k in ("device_waves", "device_pieces", "device_long_pieces",
                               "host_wave_pieces", "fused_pieces", "host_fallback_pieces",
                               "device_blocking_s", "host_wave_s", "unique_pieces")},
        "register_s": spent["_register_new_uids_arrays"],
        "dispatch_s": spent["_dispatch_device_spans"],
        "scan": scan,
    }


def chunk_bounds(chunks: list) -> list:
    out, lo = [], 0
    for _, starts, _, _ in chunks:
        out.append((lo, lo + len(starts)))
        lo += len(starts)
    return out


def crossover(host: list, device: list) -> dict:
    """Per class: the host's cost of fusing a piece beside the card's
    deferred cost of it in a wave (seconds a piece), and ``L_host``; a
    wave's parts on each route."""
    rows = []
    for h, d in zip(host, device):
        reg = d["register_deferred"]["per_piece_s"]
        card = d["deferred"]["per_piece_s"] + reg
        fuse = h["fused_s_per_piece"] + h["wide_share"] * (reg + h["batched"]["per_piece_s"])
        rows.append({
            "class": h["class"], "host_fused_s": fuse, "card_deferred_s": card,
            "host_cheaper": fuse <= card,
            "register_s": reg,
            "host_wave": {"per_wave_s": h["batched"]["per_wave_s"],
                          "per_piece_s": h["batched"]["per_piece_s"]},
            "card_wave_deferred": {"per_wave_s": d["deferred"]["per_wave_s"],
                                   "per_piece_s": d["deferred"]["per_piece_s"]},
            "card_wave_now": {"per_wave_s": d["now"]["per_wave_s"],
                              "per_piece_s": d["now"]["per_piece_s"]},
        })
    l_host = 0
    for r in rows:
        if not r["host_cheaper"]:
            break
        l_host = r["class"][1]
    # Small waves: per class and way, the largest measured size up to
    # which the host's wave is no dearer than the card's at every size.
    cells = []  # (n, host s, card s) of every class above L_host, both ways
    for r, h, d in zip(rows, host, device):
        hosts = {p["n"]: p["wave_s"] for p in h["batched"]["points"]}
        r["host_wave_max"] = {}
        for way in ("deferred", "now"):
            m, lost = 0, False
            for p in sorted(d[way]["points"], key=lambda p: p["n"]):
                if p["n"] not in hosts:
                    continue
                lost = lost or hosts[p["n"]] > p["wave_s"]
                m = m if lost else p["n"]
                if r["class"][0] > l_host:
                    cells.append((p["n"], hosts[p["n"]], p["wave_s"]))
            r["host_wave_max"][way] = m
    return {"classes": rows, "L_host": l_host, **wave_threshold(cells)}


def wave_threshold(cells: list) -> dict:
    """The wave size ``t`` (0 or a measured size) for the rule "a wave of
    at most ``t`` pieces merges on the host, a larger one on the card"
    whose worst wrong decision over ``cells`` (``(n, host s, card s)``:
    every class the scan leaves to a wave, deferred and at once) costs the
    least blocking time: ``host_wave_max`` and that cost, ``regret_s``,
    beside each candidate's."""
    sizes = sorted({0} | {n for n, _, _ in cells})
    regret = {t: max([0.0] + [(h - c) if n <= t else (c - h) for n, h, c in cells])
              for t in sizes}
    best = min(sizes, key=lambda t: (regret[t], t))
    return {"host_wave_max": best, "regret_s": regret[best],
            "regret_by_threshold": {str(t): r for t, r in regret.items()}}


def measure(mb: float, seed: int, rounds: int, device: str, sizes=SIZES,
            pieces_only: bool = False) -> dict:
    import numpy as np

    import tokenizer_tpu_torch as tt
    from bench_torch import load_benchmark, reference_ids, seed_text
    from chip_smoke import gen_corpus
    from tokenizer_tpu_torch.runtime import native

    (stream,) = [w for w in load_benchmark()["workloads"] if w["entry"] == "encode_batch_stream"]
    k = stream["chunk_docs"]
    docs = gen_corpus(mb, seed, seed_text())
    datas = [d.encode("utf-8") for d in docs]
    want = reference_ids("cl100k_synth", docs)
    chunks = []
    for i in range(0, len(docs), k):
        lens = np.array([len(d) for d in datas[i : i + k]], dtype=np.int64)
        ends = np.cumsum(lens)
        chunks.append((b"".join(datas[i : i + k]), ends - lens, ends, want[i : i + k]))

    if pieces_only:
        tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu", mesh=None)
        return {"bytes": sum(len(b) for b, _, _, _ in chunks), "docs": len(docs), "seed": seed,
                "pieces": first_seen(tok, chunks, np.random.default_rng(seed))["report"]}
    passes = {r: [] for r in ROUTINGS}
    for _ in range(rounds):
        for r in ROUTINGS:
            passes[r].append(routing_pass(r, chunks, docs, want, device))
    routings = []
    for r, runs in passes.items():
        routings.append({"routing": r, "median_MBps": _median([x["MBps"] for x in runs]),
                         "runs": runs})

    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device, mesh=None)
    tok._ensure_device()
    rng = np.random.default_rng(seed)
    seen = first_seen(tok, chunks, rng)
    threads = native.default_threads()
    host = host_costs(tok, seen["pieces"], rounds, rng, sizes, threads)
    for pieces in seen["pieces"].values():  # warm: the table, the buffers, the build
        device_wave(tok, pieces, sizes[0], rng, True)
    device_costs_ = device_costs(tok, seen["pieces"], rounds, rng, sizes)
    return {
        "bytes": sum(len(b) for b, _, _, _ in chunks), "docs": len(docs), "chunks": len(chunks),
        "chunk_docs": k, "seed": seed, "rounds": rounds, "device": device, "threads": threads,
        "sizes": list(sizes),
        "pieces": seen["report"],
        "routings": routings,
        "host": host,
        "device_waves": device_costs_,
        "crossover": crossover(host, device_costs_),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="a wave's sizes in pieces, comma-separated")
    ap.add_argument("--pieces-only", action="store_true",
                    help="report the first-seen pieces by class and nothing else (no card needed)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "router_crossover.json")
    args = ap.parse_args(argv)
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(ROOT / "build" / "tokenizer_tpu_cache"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from ab_turns import smi

    card = smi() if args.device.startswith("cuda") and not args.pieces_only else "cpu (no card)"
    print(f"card: {card}", flush=True)
    sizes = tuple(int(x) for x in args.sizes.split(","))
    record = measure(args.mb, args.seed, args.rounds, args.device, sizes, args.pieces_only)
    record["card"] = card
    print(json.dumps(record), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
