#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tokenizer_tpu_torch) on one NVIDIA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure exits non-zero before the
result line):

1. device: torch and CUDA versions, the card's name and power limit, and
   the native C++ scanner (without it the pipeline would take a Python
   path);
2. build: the CUDA kernels compile with nvcc from ``tokenizer_tpu_torch/csrc``;
3. kernel vs plain: for the gpt2, cl100k_synth and o200k_synth pair
   tables (o200k_synth, 2^21 slots, is the largest the port serves), one
   ``[L, 8192]`` tile of real corpus pieces per packer bucket L goes
   through the CUDA merge kernel (warp per column), the port's first merge
   kernel (thread per column) and the plain PyTorch version on the card
   (all equal, exactly) and through the native C++ heap merge on the host
   (1024 columns); the probe kernel is held to ``PairTable.lookup`` on
   65,536 pairs.  Each kernel's device time (launches queued behind a
   sleep kernel, CUDA events; the plain merge by CUDA events around each
   call) is set beside the tile's bound: its bytes over 3.35 TB/s, the
   tile in and out and the table bytes of the distinct pairs the plain
   merge had to probe, each slot once (``table_bytes``).  Then the card's
   own buckets beyond the packer's (``LONG_BUCKETS``, 1024 and 2048): for
   cl100k_synth, ``[L, 128]`` and ``[L, 8192]`` tiles of phase 5's corpus
   pieces of 513-2,048 bytes (its CJK runs) through the kernel, equal to
   the plain merge and the native host merge, with the kernel's device
   time and bound beside the plain merge's and ``bpe_encode_batch_spans``'
   on the same pieces;
4. main path, gpt2: ``encode_batch`` of ``tests/testdata/lib.rs.txt`` with
   every wave forced onto the card must give the 11,378 golden ids;
5. main path, cl100k_synth: an ~8 MB cold corpus made from ``--seed``
   streams through ``encode_batch_stream`` in 256-document chunks and must
   equal, document for document, a host-routed tokenizer of the same
   vocabulary (every wave merged by the native C++ heap merge, no card),
   and must have merged pieces over 512 bytes on the card;
   bulk trims and decode are checked on 64 fresh documents;
6. probe experiments, on the three tables of phase 3 (the same table
   builds): the row-copy (K3, each pair's probe window copied in one
   round trip), the L2-resident row (K4, every round's slot loaded before
   the first compare) and the one-hot int8 tensor-core (K5, one wgmma
   GEMM over every round) probe kernels equal their plain PyTorch
   versions on a ``[16, 128]`` tile and ``PairTable.lookup`` on 65,536
   pairs; then the experiment's own path, ``exp_probe.run_arms``
   (``tools/exp_cuda_probe.py``), runs every arm on every table on the
   ``[16, 128]`` tile, and K1's probe, K3 and K4 on a ``[1024, 128]``
   tile of 131,072 pairs too, bit-exact, with kernel and plain times.
   Per table and tile, K3's and K4's device time is set beside the
   tile's byte bound, the bytes of their windows
   (``probe_cuda.probe_windows``) and K1's probe on the same tile; K5's
   beside its operations bound (2 M K N int8 operations at the H100's
   1,979 TOP/s) and ``torch._int_mm`` on the same product
   (``exp_probe.onehot_product``), which only this script calls;
7. corpus path: a 64 MB cl100k_synth corpus made from ``--seed``, one
   file per document under ``build/``, goes (a) through
   ``encode_corpus(iter_corpus_files([dir]), tok, out)`` on the card with
   default routing and 8 MB chunks: the merge kernel must be launched and
   every ``tokens_*.npz`` must equal a host-routed tokenizer's ids for
   the same chunk; (b) a second run stopped by its document source after
   its fourth chunk and then resumed must leave the same npz arrays
   (their ``.npy`` members byte for byte: the zip headers carry a write
   time); (c) ``python3 -m tokenizer_tpu_torch.cli corpus`` in a
   subprocess on the card must write them too; (d) the CLI's
   ``encode-file`` gives the 11,378 gpt2 ids of lib.rs.txt and ``bench``
   its JSON; (e) ``runtime.profiler.trace`` around one forced
   ``encode_batch`` of a fresh chunk, in a process of its own, writes a
   trace that names ``merge_packed_kernel`` and shows one pinned
   host-to-device copy per device wave;
8. multi-device path, on every card when there are more than one, else
   on two shards of ``cuda:0`` (each with its own stream, upload and
   launches): (a) ``parallel.dryrun.dryrun_multidevice`` (one raw
   sharded step with its counters and shard layout, ``encode_batch``,
   the stream, both bulk trims and ``decode_batch`` against the host
   engine); (b) phase 5's 8 MB cold corpus through ``encode_batch_stream``
   of a mesh tokenizer must equal phase 5's host reference document for
   document, with the merge kernel launched on every shard's stream and
   one upload per shard and wave; (c) ``tools/fuzz_campaign_torch.py``'s
   ``encode``, ``trim``, ``threads`` and ``mesh`` bodies on the card for
   ``CAMPAIGN_S`` seconds each from a fixed seed, without a mismatch;
9. parity on the card, every wave forced onto the merge kernel: (a)
   lib.rs.txt under gpt2, r50k_base, p50k_base, p50k_edit, cl100k_synth
   and o200k_synth through ``encode_batch`` equals the committed
   ``tests/testdata/tokens_*.json`` (the synthetic ones are tiktoken's ids,
   ``tools/synth_goldens.py``) and decodes back; (b) phase 5's 8 MB cold
   corpus through an o200k_synth ``encode_batch_stream`` (pattern 3, the
   2^21-slot table) equals a host-routed o200k_synth tokenizer document
   for document; (c) cl100k_synth cases with waves in flight while the
   host scans on (``IN_FLIGHT``), each against the host engine: a stream
   whose dedup generations rotate between chunks, a stream closed with a
   chunk deferred, bulk calls between a stream's chunks on the deferred
   chunk's pieces, device chunks followed by host-routed emit chunks, and
   four threads on one tokenizer.

The merge kernels' launch counts are reset before phase 4 and read after
phase 5 (the first merge kernel must not be launched there), reset
again just before phase 7 (a) and read after it, again (with the
per-stream counts) just before phase 8 (b) and read after it, and again
just before phase 9 and read after it; the probe kernels' counts are
reset just before ``run_arms`` and read after it.
The last lines are the card's name and power limit, the
``{"kernels": [...]}`` record, and ``{"ok": true, "device": {...}}``.
Builds go under ``build/`` in the checkout.  The script imports nothing
of the JAX package and never jax; it checks both at its end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUCKETS = (16, 64, 128, 256, 512)  # tokenizer_tpu_torch/ops/packing.py BUCKETS
TILE_B = 8192  # the packer's widest tile (packing.py MAX_B)
#: The card's own buckets beyond BUCKETS (gpu.py DEVICE_BUCKETS), timed in
#: phase 3 on the long pieces of phase 5's corpus, beside the native host
#: merge, at one wave's share of columns and at the packer's widest tile.
LONG_BUCKETS = (1024, 2048)
LONG_TILES = (128, TILE_B)
HOST_COLS = 1024
LOOKUP_PAIRS = 65536
CHUNK_DOCS = 256
CORPUS_MB = 8.0
CORPUS7_MB = 64.0
#: phase 7 (b) stops its run when the document source reaches this chunk.
STOP_CHUNK = 4
#: seconds of each campaign body in phase 8 (c), and their seed.
CAMPAIGN_S = 12.0
CAMPAIGN_SEED = 2026
REPS = 5
KERNEL = "merge_packed"
KERNEL_SOURCE = "tokenizer_tpu_torch/csrc/merge_packed.cu"
REPLACES = "tokenizer_tpu/ops/merge_pallas.py:213"
#: the XLA merge that the same kernel also replaces (the mesh step's body).
ALSO_REPLACES = ["tokenizer_tpu/ops/merge_jax.py:83"]
PROBE_KERNELS = ("probe_rows_async", "probe_rows_resident", "lookup_onehot")  # K3, K4, K5
#: The tables of phases 3 and 6, each built once.
TABLES = ("gpt2", "cl100k_synth", "o200k_synth")
#: NVIDIA H100 SXM device memory rate, bytes/s (data sheet).
HBM_BYTES_PER_S = 3.35e12
#: Bytes of one pair-table slot: key_left, key_right, value.
SLOT_BYTES = 12
#: Bytes of one slot's key_left, which every probe reads first.
KEY_BYTES = 4
#: NVIDIA H100 SXM dense int8 tensor-core peak, operations/s (data sheet).
INT8_OPS_PER_S = 1979e12

_WORDS = (
    "the of and to in is was he for it with as his on be at by had not are"
    " but from or have an they which one you were all her she there would"
    " their we him been has when who will no more if out so up said what"
    " its about than into them can only other time new some could these"
    " two may first then do any like my now over such our man me even most"
    " made after also did many off before must well back through years"
    " where much your way down should because each just those people how"
    " too little state good very make world still see own men work long"
    " here get both between life being under never day same another know"
    " while last might us great old year come since against go came right"
    " used take three".split()
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gen_corpus(target_mb: float, seed: int, seed_text: str) -> list:
    """Cold documents of four kinds (bench.py gen_corpus): code from the
    seed text with fresh identifiers, Zipf-ish prose with fresh rare
    words, numeric log lines, and CJK runs with accents and stars."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chunks = [seed_text[i : i + 8192] for i in range(0, len(seed_text), 8192)]
    alpha = "abcdefghijklmnopqrstuvwxyz"
    docs, total, k = [], 0, 0
    while total < int(target_mb * 1e6):
        kind = k % 4
        k += 1
        if kind == 0:
            c = chunks[int(rng.integers(len(chunks)))]
            suf = "_" + "".join(alpha[i] for i in rng.integers(0, 26, size=6))
            doc = c.replace("self", "slf" + suf).replace("fn ", "fn x" + suf)
        elif kind == 1:
            n = int(rng.integers(600, 1400))
            words = [_WORDS[i] for i in rng.zipf(1.3, size=n) % len(_WORDS)]
            for j in range(0, n, 37):
                words[j] = "".join(
                    alpha[i] for i in rng.integers(0, 26, size=int(rng.integers(5, 12)))
                )
            doc = " ".join(words)
        elif kind == 2:
            doc = "\n".join(
                f"[{int(rng.integers(1e9)):010d}] metric_{int(rng.integers(1e4))}"
                f" = {rng.random():.9f} ({int(rng.integers(1e6))} us)"
                for _ in range(int(rng.integers(40, 120)))
            )
        else:
            cps = rng.integers(0x4E00, 0x4E00 + 2000, size=int(rng.integers(200, 600)))
            doc = "".join(map(chr, cps)) + " étoile ⭐ " * int(rng.integers(1, 5))
        docs.append(doc)
        total += len(doc.encode("utf-8"))
    return docs


def synth_bucket_pieces(rng, lo: int, hi: int, count: int) -> list:
    """Pieces of lo < len <= hi bytes (bench.py _synth_bucket_pieces):
    CJK runs (3-byte characters, never split), digit runs and no-space
    ASCII identifier runs, in turn."""
    out = []
    for k in range(count):
        kind = k % 3
        target = int(rng.integers(lo + 1, hi + 1))
        if kind == 0:
            cps = rng.integers(0x4E00, 0x4E00 + 2000, size=max(1, target // 3))
            out.append("".join(chr(c) for c in cps).encode("utf-8"))
        elif kind == 1:
            out.append(bytes(rng.integers(48, 58, size=target).astype("u1")))
        else:
            out.append(bytes(rng.integers(97, 123, size=target).astype("u1")))
    return [p for p in out if lo < len(p) <= hi]


def bucket_pieces(tok, docs, rng, count: int) -> dict:
    """Per bucket L, ``count`` pieces with prev_L < len <= L: the corpus's
    own regex pieces first, topped up with CJK, digit and identifier runs
    where the corpus has too few."""
    seen = set()
    for d in docs[:400]:
        seen.update(p.encode("utf-8") for p in tok._re.findall(d))
    out, prev = {}, 1
    for L in BUCKETS:
        pool = sorted(p for p in seen if prev < len(p) <= L)
        if len(pool) > count:
            pool = [pool[i] for i in sorted(rng.choice(len(pool), count, replace=False))]
        out[("corpus", L)] = len(pool)
        while len(pool) < count:
            pool += synth_bucket_pieces(rng, prev, L, count - len(pool))
        out[L] = pool
        prev = L
    return out


def pack(table, pieces, L):
    import numpy as np

    ids = np.full((L, len(pieces)), -1, np.int32)
    lengths = np.zeros(len(pieces), np.int32)
    for c, p in enumerate(pieces):
        ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    return ids, lengths


def bound_us(nbytes: int) -> float:
    """The least time, in µs, that moving ``nbytes`` through device memory
    takes; integer work has no published peak, so bytes bound these kernels."""
    return nbytes / HBM_BYTES_PER_S * 1e6


def table_bytes(table, left, right) -> tuple:
    """(bytes, distinct pairs): the pair-table bytes that probing the
    pairs (left, right) must read, each slot once.  Every distinct pair
    of valid ids reads the key_left of its home slot (4 B, once per
    distinct home slot); a pair that hits also reads the key_right and
    value of its own slot (8 B).  Pairs with a negative id read nothing."""
    import numpy as np

    from tokenizer_tpu_torch.ops.pair_table import MAX_RANK, hash_pair_u32

    left, right = np.asarray(left, np.int64), np.asarray(right, np.int64)
    ok = (left >= 0) & (right >= 0)
    keys = np.unique((left[ok] << 32) | right[ok])
    l, r = (keys >> 32).astype(np.int32), (keys & 0xFFFFFFFF).astype(np.int32)
    homes = np.unique(hash_pair_u32(l, r, table.slot_bits)).size
    hits = int((table.lookup(l, r) != MAX_RANK).sum())
    return KEY_BYTES * homes + (SLOT_BYTES - KEY_BYTES) * hits, keys.size


def plain_and_bound(table, tab, ids, lengths) -> tuple:
    """The plain merge of one packed ``[L, B]`` tile (int32 tensors on one
    device), and the tile's bound: the tile in and out plus
    ``table_bytes`` of every distinct pair the merge probes, over
    ``HBM_BYTES_PER_S``.  Only the tile's inputs enter the bound (the
    pairs follow from them), so no implementation of the merge can take
    less time.  Returns ``((out_ids, out_n), {"bound_us", "tile_bytes",
    "table_bytes", "pairs"})``."""
    import torch

    from tokenizer_tpu_torch.ops.merge_torch import merge_packed_torch

    probed = []  # every pair the merge needs, as left << 32 | right

    def on_probe(left, right):
        ok = (left >= 0) & (right >= 0)
        probed.append((left[ok].long() << 32) | right[ok].long())

    out = merge_packed_torch(tab, ids, lengths, slot_bits=table.slot_bits,
                             max_probes=table.max_probes, on_probe=on_probe)
    keys = torch.unique(torch.cat(probed)).cpu().numpy()
    tile_bytes = 2 * 4 * ids.numel() + 2 * 4 * lengths.numel()  # int32 in and out
    tab_bytes, n_pairs = table_bytes(table, keys >> 32, keys & 0xFFFFFFFF)
    return out, {"bound_us": bound_us(tile_bytes + tab_bytes), "tile_bytes": tile_bytes,
                 "table_bytes": tab_bytes, "pairs": n_pairs}


def kernel_vs_plain(tok, pieces_by_L, device, rng) -> dict:
    """Phase 3 for one vocabulary; returns per-bucket times of both merge
    kernels and the plain merge, each bucket's bound, and the largest
    |kernel - plain| seen."""
    import numpy as np
    import torch

    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.ops.exp_probe import median_ms, queued_ms
    from tokenizer_tpu_torch.ops.merge_torch import device_table, merge_packed_torch

    table = tok.table
    tab = device_table(table, device)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    name = tok.vocab.name
    res = {"ms": {}, "v1_ms": {}, "plain_ms": {}, "bound_us": {}, "max_abs_err": 0}
    for L in BUCKETS:
        ids, lengths = pack(table, pieces_by_L[L], L)
        di = torch.from_numpy(ids).to(device)
        dl = torch.from_numpy(lengths).to(device)
        k_ids, k_n = merge_cuda.merge_packed(tab, di, dl, **kw)
        v_ids, v_n = merge_cuda.merge_packed_v1(tab, di, dl, **kw)
        (p_ids, p_n), bound = plain_and_bound(table, tab, di, dl)
        torch.cuda.synchronize()
        for what, (o_ids, o_n) in (("kernel", (k_ids, k_n)), ("first kernel", (v_ids, v_n))):
            err = max(
                int((o_ids.long() - p_ids.long()).abs().max()),
                int((o_n.long() - p_n.long()).abs().max()),
            )
            res["max_abs_err"] = max(res["max_abs_err"], err)
            check(err == 0, f"{name} L={L}: {what} != plain (max |diff| {err})")
        # The native C++ heap merge on the host, one piece per column.
        h_out, h_offs, h_n = tok._native.bpe_encode_batch(pieces_by_L[L][:HOST_COLS], table)
        got_ids, got_n = k_ids[:, :HOST_COLS].cpu().numpy(), k_n[:HOST_COLS].cpu().numpy()
        check(
            np.array_equal(got_n, h_n)
            and all(
                np.array_equal(got_ids[: h_n[c], c], h_out[h_offs[c] : h_offs[c] + h_n[c]])
                for c in range(HOST_COLS)
            ),
            f"{name} L={L}: kernel != native C++ merge on {HOST_COLS} columns",
        )
        # Device time alone: CUDA events around one launch of a few tens
        # of µs time the host's enqueue instead.
        dev = {
            "new": queued_ms(partial(merge_cuda.merge_packed, tab, di, dl, **kw)),
            "first": queued_ms(partial(merge_cuda.merge_packed_v1, tab, di, dl, **kw)),
        }
        plain = median_ms(partial(merge_packed_torch, tab, di, dl, **kw))
        out_n = k_n.cpu().numpy().astype(np.int64)
        b_us, tile_bytes = bound["bound_us"], bound["tile_bytes"]
        tab_bytes, n_pairs = bound["table_bytes"], bound["pairs"]
        res["ms"][L], res["v1_ms"][L] = dev["new"], dev["first"]
        res["plain_ms"][L], res["bound_us"][L] = plain, b_us
        merges = int((lengths - out_n).sum())
        print(
            f"phase 3 {name} [{L}, {TILE_B}] ({pieces_by_L[('corpus', L)]} corpus pieces, "
            f"rest synthesized) kernel == first kernel == plain (exact), == native C++ merge "
            f"on {HOST_COLS} cols; merges {merges}; device ms (queued): kernel "
            f"{dev['new']:.4f}, first kernel {dev['first']:.4f}; plain {plain:.4f} ms (CUDA "
            f"events, median of {REPS}); bound {b_us:.3f} us (bytes: tile {tile_bytes}, table "
            f"{tab_bytes} for {n_pairs} distinct pairs probed): kernel "
            f"{b_us / 1e3 / dev['new']:.4%}, first kernel {b_us / 1e3 / dev['first']:.4%} of it",
            flush=True,
        )
    # The probe alone: hits from the table, random pairs, negatives.
    left, right = lookup_pairs_set(table, rng, LOOKUP_PAIRS)
    got = merge_cuda.lookup_pairs(
        tab, torch.from_numpy(left).to(device), torch.from_numpy(right).to(device), **kw
    )
    check(
        np.array_equal(got.cpu().numpy(), table.lookup(left, right)),
        f"{name}: tt_lookup_pairs != PairTable.lookup",
    )
    print(f"phase 3 {name} tt_lookup_pairs == PairTable.lookup on {LOOKUP_PAIRS} pairs", flush=True)
    return res


def long_pieces(tok, docs) -> dict:
    """Per L of ``LONG_BUCKETS``, the distinct regex pieces of ``docs``
    with prev_L < len <= L (the first prev_L is BUCKETS' widest), sorted."""
    seen = set()
    for d in docs:
        seen.update(b for b in (p.encode("utf-8") for p in tok._re.findall(d)) if len(b) > BUCKETS[-1])
    out, prev = {}, BUCKETS[-1]
    for L in LONG_BUCKETS:
        out[L] = sorted(p for p in seen if prev < len(p) <= L)
        prev = L
    return out


def host_ms(fn, reps: int = REPS) -> float:
    """Median wall ms of ``reps`` host calls of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def long_vs_host(tok, pool_by_L, device, rng, smi: str) -> dict:
    """Phase 3's long rows, cl100k_synth: per L of ``LONG_BUCKETS`` and B
    of ``LONG_TILES``, an ``[L, B]`` tile of the corpus's long pieces (each
    column one piece of ``pool_by_L[L]``, drawn in a random order, the pool
    repeated where it has fewer than B) through the merge kernel, equal to
    the plain merge and to the native host merge; the kernel's device time
    beside ``plain_and_bound``'s bound, the plain merge (CUDA events, one
    timed call) and the port's ``bpe_encode_batch_spans`` on the same
    pieces at the default threads (host wall, median of ``REPS``)."""
    import numpy as np
    import torch

    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.ops.exp_probe import median_ms, queued_ms
    from tokenizer_tpu_torch.ops.merge_torch import device_table, merge_packed_torch
    from tokenizer_tpu_torch.runtime.native import bpe_encode_batch_spans, default_threads

    table = tok.table
    tab = device_table(table, device)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    res = {"ms": {}, "plain_ms": {}, "bound_us": {}, "host_ms": {}, "merges": {}, "max_abs_err": 0}
    for L in LONG_BUCKETS:
        pool = pool_by_L[L]
        check(pool, f"phase 3: the corpus has no piece for L={L}")
        order = rng.permutation(len(pool))
        for B in LONG_TILES:
            pieces = [pool[order[i % len(pool)]] for i in range(B)]
            ids, lengths = pack(table, pieces, L)
            di = torch.from_numpy(ids).to(device)
            dl = torch.from_numpy(lengths).to(device)
            k_ids, k_n = merge_cuda.merge_packed(tab, di, dl, **kw)
            (p_ids, p_n), bound = plain_and_bound(table, tab, di, dl)
            torch.cuda.synchronize()
            err = max(int((k_ids.long() - p_ids.long()).abs().max()),
                      int((k_n.long() - p_n.long()).abs().max()))
            res["max_abs_err"] = max(res["max_abs_err"], err)
            check(err == 0, f"cl100k_synth [{L}, {B}]: kernel != plain (max |diff| {err})")
            buf = b"".join(pieces)
            ends = np.cumsum([len(p) for p in pieces], dtype=np.int64)
            starts = ends - lengths.astype(np.int64)
            h_out, h_offs, h_n = bpe_encode_batch_spans(buf, starts, ends, table)
            got_ids, got_n = k_ids.cpu().numpy(), k_n.cpu().numpy()
            check(np.array_equal(got_n, h_n) and all(
                np.array_equal(got_ids[: h_n[c], c], h_out[h_offs[c] : h_offs[c] + h_n[c]])
                for c in range(B)), f"cl100k_synth [{L}, {B}]: kernel != native host merge")
            key = f"{L}x{B}"
            res["ms"][key] = queued_ms(partial(merge_cuda.merge_packed, tab, di, dl, **kw))
            res["plain_ms"][key] = median_ms(partial(merge_packed_torch, tab, di, dl, **kw), reps=1)
            res["host_ms"][key] = host_ms(partial(bpe_encode_batch_spans, buf, starts, ends, table))
            res["bound_us"][key] = bound["bound_us"]
            res["merges"][key] = int((lengths - h_n).sum())
            ms, b_us, h = res["ms"][key], bound["bound_us"], res["host_ms"][key]
            print(
                f"phase 3 cl100k_synth long [{L}, {B}] ({len(pool)} distinct corpus pieces of "
                f"{min(map(len, pool))}-{max(map(len, pool))} bytes; longest chain "
                f"{int((lengths - h_n).max())} merges, {res['merges'][key]} in all) kernel == "
                f"plain == native host merge (exact); device ms (queued): kernel {ms:.4f}; plain "
                f"{res['plain_ms'][key]:.4f} ms (CUDA events, one call); bound {b_us:.3f} us "
                f"(bytes: tile {bound['tile_bytes']}, table {bound['table_bytes']} for "
                f"{bound['pairs']} distinct pairs): {b_us / 1e3 / ms:.4%} of it; native "
                f"bpe_encode_batch_spans {h:.4f} ms at {default_threads()} threads (host wall, "
                f"median of {REPS}): kernel {h / ms:.2f}x faster; card {smi}",
                flush=True,
            )
    return res


def lookup_pairs_set(table, rng, n: int):
    """n int32 pairs: half keys of the table, the rest random ids from -2
    up (misses and invalid ids)."""
    import numpy as np

    keys = np.nonzero(table.key_left >= 0)[0]
    hits = rng.choice(keys, n // 2, replace=False)
    rest = n - hits.size
    left = np.concatenate([table.key_left[hits], rng.integers(-2, table.n_vocab, rest)])
    right = np.concatenate([table.key_right[hits], rng.integers(-2, table.n_vocab, rest)])
    return left.astype(np.int32), right.astype(np.int32)


def probe_vs_plain(table, name, device, rng) -> dict:
    """Phase 6 checks for one table: K3, K4, K5 == plain on [16, 128] and
    == PairTable.lookup on LOOKUP_PAIRS pairs.  Returns the largest
    |kernel - plain| per kernel."""
    import numpy as np
    import torch

    from tokenizer_tpu_torch.ops import exp_probe

    calls = exp_probe.arm_calls(table, device)
    small = [torch.from_numpy(a).to(device) for a in exp_probe.make_probes(table, exp_probe.SHAPE)]
    l_np, r_np = lookup_pairs_set(table, rng, LOOKUP_PAIRS)
    big = [torch.from_numpy(a.reshape(-1, 128)).to(device) for a in (l_np, r_np)]
    want = table.lookup(l_np, r_np).reshape(-1, 128)
    errs = {}
    for k in PROBE_KERNELS:
        kernel, plain = calls[k]
        with exp_probe.l2_for(k, table, device):
            got, got_big = kernel(*small), kernel(*big)
            torch.cuda.synchronize()
        errs[k] = int((got.long() - plain(*small).long()).abs().max())
        check(errs[k] == 0, f"{name} {k}: kernel != plain on {exp_probe.SHAPE} (max |diff| {errs[k]})")
        check(np.array_equal(got_big.cpu().numpy(), want),
              f"{name} {k}: kernel != PairTable.lookup on {LOOKUP_PAIRS} pairs")
        print(f"phase 6 {name} {k}: kernel == plain on {list(exp_probe.SHAPE)}, "
              f"== PairTable.lookup on {LOOKUP_PAIRS} pairs", flush=True)
    return errs


def onehot_yardstick(table, name, device) -> dict:
    """Phase 6's yardstick for K5: ``torch._int_mm`` on the kernel's own
    product for run_arms' ``[16, 128]`` tile (the one-hot matrix made
    before the timing, B the K-major table viewed as [K, N]), checked
    against the rows of B it selects; beside it the product's operations
    bound and the bytes of B that the kernel's tiling moves from L2 to
    shared memory per call."""
    import torch

    from tokenizer_tpu_torch.ops import exp_probe, probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe_torch import bigtable_device_table, bigtable_kmajor

    S, mp = exp_probe.SHAPE[0], table.max_probes
    left, right = (torch.from_numpy(a).to(device) for a in exp_probe.make_probes(table, exp_probe.SHAPE))
    tab_k = bigtable_kmajor(bigtable_device_table(table, device))
    a, b, target = exp_probe.onehot_product(tab_k, left, right, slot_bits=table.slot_bits,
                                            max_probes=mp)
    got = torch._int_mm(a, b)
    check(torch.equal(got, b[target].to(torch.int32)), f"{name}: torch._int_mm != the rows of B")
    ms = exp_probe.queued_ms(lambda: torch._int_mm(a, b))
    ops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
    return {"library_ms": ms, "ops": ops, "ops_bound_us": ops / INT8_OPS_PER_S * 1e6,
            "l2_to_smem_bytes": probe_cuda.onehot_tiling(S, mp, a.shape[1]).l2_to_smem_bytes}


def tile_key(shape) -> str:
    return "x".join(map(str, shape))


def probe_bound_us(table, shape) -> float:
    """The bound of phase 6's lookup of one ``make_probes`` tile: the
    pairs in and the ids out, and the table bytes its distinct valid
    pairs read."""
    from tokenizer_tpu_torch.ops import exp_probe

    left, right = exp_probe.make_probes(table, shape)
    return bound_us(3 * left.nbytes + table_bytes(table, left, right)[0])


def window_bytes(table, shape) -> int:
    """The bytes K3 copies (and K4 loads) for one ``make_probes`` tile."""
    from tokenizer_tpu_torch.ops import exp_probe, probe_cuda

    left, right = exp_probe.make_probes(table, shape)
    homes = probe_cuda.pair_homes(left, right, table.slot_bits)
    return probe_cuda.probe_windows(homes, table.max_probes, table.slot_bits).bytes


#: Phase 7 (e) in a process of its own: a torch.profiler session late in
#: this one, after phase 6's sessions, left the merge kernel out of its
#: trace on an H100.  argv: a JSON list of documents, the trace directory.
TRACE_RUN = r"""
import json, sys
import torch
import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.runtime.profiler import trace

docs_path, log_dir = sys.argv[1:3]
tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cuda")
tok._host_pp = float("inf")  # every wave to the card
tok._host_wave_max = 0
tok._ensure_device()
docs = json.loads(open(docs_path, encoding="utf-8").read())
with trace(log_dir):
    tok.encode_batch(docs)
    torch.cuda.synchronize()
print(json.dumps({"launches": merge_cuda.LAUNCHES, "device_waves": tok.stats.device_waves}))
"""


def npz_arrays(out_dir: Path) -> dict:
    """Every ``tokens_*.npz`` of a directory as {file: {member: bytes}}:
    the arrays' ``.npy`` bytes (a zip header carries its write time)."""
    import zipfile

    got = {}
    for f in sorted(out_dir.glob("tokens_*.npz")):
        with zipfile.ZipFile(f) as z:
            got[f.name] = {n: z.read(n) for n in sorted(z.namelist())}
    return got


def host_reference(name: str):
    """Phase 5's reference: every wave to the native C++ heap merge."""
    import tokenizer_tpu_torch as tt

    ref = tt.create_by_encoder_name(name, allow_fetch=False, device="cpu")
    ref._host_wave_max = sys.maxsize
    return ref


def corpus_phase(seed: int, seed_text: str, device, smi: str) -> dict:
    """Phase 7, the corpus path; returns its launches and MB/s."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch import cli
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.runtime import pipeline

    work = ROOT / "build" / "phase7"
    shutil.rmtree(work, ignore_errors=True)
    corpus = work / "corpus"
    corpus.mkdir(parents=True)
    t0 = time.perf_counter()
    made = gen_corpus(CORPUS7_MB, seed, seed_text)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, doc in enumerate(made):
        (corpus / f"doc{i:06d}.txt").write_text(doc, encoding="utf-8")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    docs = list(pipeline.iter_corpus_files([str(corpus)]))
    read_s = time.perf_counter() - t0
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    chunks = list(pipeline._chunks(docs, 8 << 20, 0, 1))  # encode_corpus's own grouping
    check(len(chunks) > STOP_CHUNK, f"the corpus makes only {len(chunks)} chunks")
    print(f"phase 7 corpus: {len(docs)} files, {nbytes} bytes, {len(chunks)} chunks of "
          f"8 MB; {gen_s:.3f} s to make, {write_s:.3f} s to write, {read_s:.3f} s to read "
          "back with iter_corpus_files", flush=True)

    def card_tok():
        tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device)
        tok._ensure_device()  # table upload outside the timed region
        return tok

    # (a) default routing, default chunks, in process.
    tok = card_tok()
    merge_cuda.LAUNCHES = merge_cuda.V1_LAUNCHES = 0
    t0 = time.perf_counter()
    prog = pipeline.encode_corpus(pipeline.iter_corpus_files([str(corpus)]), tok, str(work / "a"))
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    launches = merge_cuda.LAUNCHES
    st = tok.stats.as_dict()
    check(launches > 0 and st["device_pieces"] > 0,
          f"encode_corpus did not reach the kernel ({launches} launches, {st['device_pieces']} pieces)")
    check(merge_cuda.V1_LAUNCHES == 0, "encode_corpus launched the first merge kernel")
    check(prog.chunks_done == len(chunks) and prog.bytes_in == nbytes,
          f"encode_corpus: {prog.chunks_done} chunks, {prog.bytes_in} bytes")
    ref = host_reference("cl100k_synth")
    t0 = time.perf_counter()
    for ci, chunk in enumerate(chunks):
        want = ref.encode_batch(chunk)
        offsets = np.zeros(len(want) + 1, np.int64)
        np.cumsum([len(w) for w in want], out=offsets[1:])
        z = np.load(work / "a" / f"tokens_s00000_c{ci:06d}.npz")
        check(np.array_equal(z["offsets"], offsets) and np.array_equal(z["ids"], np.concatenate(want)),
              f"encode_corpus chunk {ci} != the host-routed reference")
    ref_s = time.perf_counter() - t0
    check(ref.stats.device_pieces == 0, "the reference tokenizer used a device")
    # The same chunks from memory through a fresh tokenizer: the encode
    # alone, without the files.
    t0 = time.perf_counter()
    for _ in card_tok().encode_batch_stream(chunks):
        pass
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    print(f"phase 7 (a) encode_corpus == host reference on {len(chunks)} chunks, {prog.docs} docs, "
          f"{prog.tokens_out} tokens; {nbytes / corpus_s / 1e6:.3f} MB/s ({corpus_s:.3f} s; "
          f"manifest seconds {prog.seconds:.3f}; the same chunks from memory: "
          f"encode_batch_stream {nbytes / stream_s / 1e6:.3f} MB/s, host-routed reference "
          f"encode_batch {nbytes / ref_s / 1e6:.3f} MB/s); "
          f"device_waves {st['device_waves']}, device_pieces {st['device_pieces']}, "
          f"host_wave_pieces {st['host_wave_pieces']}, fused_pieces {st['fused_pieces']}, "
          f"unique_pieces {st['unique_pieces']}, host_fallback_pieces {st['host_fallback_pieces']}, "
          f"device_blocking_s {st['device_blocking_s']:.4f}, host_wave_s {st['host_wave_s']:.4f}; "
          f"launches {launches}; card {smi}", flush=True)
    arrays = npz_arrays(work / "a")
    manifest = work / "a" / "manifest_shard00000.json"
    counters = {k: v for k, v in json.loads(manifest.read_text()).items() if k != "seconds"}

    # (b) a run stopped by its document source, then resumed.
    stop_at = sum(len(c) for c in chunks[:STOP_CHUNK])

    class Stop(Exception):
        pass

    def stopping():
        for k, doc in enumerate(pipeline.iter_corpus_files([str(corpus)])):
            if k == stop_at:
                raise Stop
            yield doc

    try:
        pipeline.encode_corpus(stopping(), card_tok(), str(work / "b"))
        fail("phase 7 (b): the stopped run did not stop")
    except Stop:
        pass
    cut = pipeline.ShardProgress.load(work / "b" / "manifest_shard00000.json")
    check(cut is not None and STOP_CHUNK - 1 <= cut.chunks_done < len(chunks),
          f"phase 7 (b): the stopped run left {cut and cut.chunks_done} chunks")
    pipeline.encode_corpus(pipeline.iter_corpus_files([str(corpus)]), card_tok(), str(work / "b"))
    resumed = json.loads((work / "b" / "manifest_shard00000.json").read_text())
    resumed.pop("seconds")
    check(npz_arrays(work / "b") == arrays, "phase 7 (b): the resumed npz differ from (a)'s")
    check(resumed == counters, f"phase 7 (b): counters {resumed} != {counters}")
    sidecar = "manifest_shard00000.digests"
    check((work / "b" / sidecar).read_bytes() == (work / "a" / sidecar).read_bytes(),
          "phase 7 (b): digest sidecars differ")
    print(f"phase 7 (b) stopped after {cut.chunks_done} of {len(chunks)} chunks, resumed: npz "
          "arrays, counters and digests == (a)'s", flush=True)

    # (c) the CLI in a subprocess on the card (inherits the build cache).
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tokenizer_tpu_torch.cli", "corpus", str(corpus),
         "--out", str(work / "c"), "--model", "cl100k_synth"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600,
    )
    check(out.returncode == 0, f"phase 7 (c): CLI corpus failed: {out.stderr[-2000:]}")
    report = out.stdout.strip().splitlines()[-1]
    check(npz_arrays(work / "c") == arrays, "phase 7 (c): the CLI's npz differ from (a)'s")
    check(json.loads(report)["global_tokens_out"] == prog.tokens_out, "phase 7 (c): token count")
    print(f"phase 7 (c) CLI corpus == (a) ({time.perf_counter() - t0:.2f} s with start-up): "
          f"{report}", flush=True)

    # (d) the CLI's encode-file and bench, in process.
    for argv in (
        ["encode-file", "gpt2", str(ROOT / "tests" / "testdata" / "lib.rs.txt")],
        ["bench", str(ROOT / "tests" / "testdata"), "--model", "gpt2", "--min-seconds", "2"],
    ):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"phase 7 (d): {argv[0]} failed")
        lines = buf.getvalue().strip().splitlines()
        if argv[0] == "encode-file":
            check(lines[0] == "tokens: 11378", f"phase 7 (d): encode-file printed {lines[0]!r}")
        else:
            check(json.loads(lines[-1])["tokens"] > 0, "phase 7 (d): bench counted no tokens")
        print(f"phase 7 (d) {argv[0]}: {' | '.join(lines)}", flush=True)

    # (e) the profiler around one forced device encode of a fresh chunk,
    # in a fresh process (TRACE_RUN).
    fresh = work / "fresh.json"
    fresh.write_text(json.dumps(gen_corpus(0.5, seed + 5, seed_text)), encoding="utf-8")
    out = subprocess.run(
        [sys.executable, "-c", TRACE_RUN, str(fresh), str(work / "trace")],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
    )
    check(out.returncode == 0, f"phase 7 (e): the traced run failed: {out.stderr[-2000:]}")
    run = json.loads(out.stdout.strip().splitlines()[-1])
    traces = list((work / "trace").glob("*.pt.trace.json"))
    check(len(traces) == 1, f"phase 7 (e): {len(traces)} trace files")
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("ph") == "X"]
    kernels = sum("merge_packed_kernel" in n for n in names)
    h2d = {kind: sum(n == f"Memcpy HtoD ({kind} -> Device)" for n in names)
           for kind in ("Pinned", "Pageable")}
    if not kernels:
        from collections import Counter

        print(f"phase 7 (e) trace event categories: "
              f"{json.dumps(Counter(e.get('cat') for e in events))}", flush=True)
    check(run["launches"] > 0, "phase 7 (e): the traced encode launched no merge kernel")
    check(kernels > 0, "phase 7 (e): the trace does not name merge_packed_kernel")
    check(h2d == {"Pinned": run["device_waves"], "Pageable": 0},
          f"phase 7 (e): host-to-device copies {h2d} for {run['device_waves']} device waves")
    print(f"phase 7 (e) trace {traces[0].relative_to(ROOT)}: {kernels} merge_packed_kernel rows "
          f"for {run['launches']} launches, host-to-device copies {json.dumps(h2d)} for "
          f"{run['device_waves']} device waves", flush=True)
    return {"launches": launches, "MBps": nbytes / corpus_s / 1e6,
            "ref_MBps": nbytes / ref_s / 1e6}


def mesh_phase(docs: list, want: list, nbytes: int, smi: str) -> dict:
    """Phase 8, the multi-device path; returns its launches and MB/s."""
    import importlib.util

    import numpy as np
    import torch

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.parallel import data_mesh, local_devices
    from tokenizer_tpu_torch.parallel.dryrun import dryrun_multidevice

    local = local_devices()
    devices = local if len(local) > 1 else local * 2
    where = (f"all {len(local)} cards" if len(local) > 1
             else f"two shards of {local[0]} (one card)")

    # (a) the dry run.
    t0 = time.perf_counter()
    dry = dryrun_multidevice(devices=devices)
    print(f"phase 8 (a) dryrun_multidevice on {where}: {json.dumps(dry)} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    # (b) phase 5's cold corpus through a mesh tokenizer.
    mesh = data_mesh(devices=devices)
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cuda", mesh=mesh)
    check(tok.mesh is mesh, "the tokenizer did not take the mesh")
    tok._ensure_device()  # the tables' uploads outside the timed region
    torch.cuda.synchronize()
    chunks = [docs[i : i + CHUNK_DOCS] for i in range(0, len(docs), CHUNK_DOCS)]
    merge_cuda.LAUNCHES = merge_cuda.V1_LAUNCHES = 0
    merge_cuda.STREAM_LAUNCHES.clear()
    t0 = time.perf_counter()
    out = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches, by_stream = merge_cuda.LAUNCHES, dict(merge_cuda.STREAM_LAUNCHES)
    st = tok.stats.as_dict()
    check(len(out) == len(docs), f"mesh stream gave {len(out)} outputs for {len(docs)} documents")
    bad = [i for i, (g, w) in enumerate(zip(out, want)) if not np.array_equal(g, w)]
    check(not bad, f"mesh cl100k_synth: {len(bad)} documents differ, first {bad[:5]}")
    check(merge_cuda.V1_LAUNCHES == 0, "the mesh path launched the first merge kernel")
    shards = [(str(d), s.cuda_stream) for d, s in zip(mesh.devices, tok._streams)]
    check(len(set(shards)) == mesh.size, f"shards share a stream: {shards}")
    check(set(by_stream) == set(shards) and all(by_stream[k] > 0 for k in shards),
          f"launches by stream {by_stream}, shard streams {shards}")
    check(st["device_uploads"] == mesh.size * st["device_waves"] and st["host_wave_pieces"] == 0,
          f"uploads {st['device_uploads']} for {st['device_waves']} waves of {mesh.size} shards")
    by_device = {}
    for (dev, _), n in by_stream.items():
        by_device[dev] = by_device.get(dev, 0) + n
    print(f"phase 8 (b) mesh encode_batch_stream on {where} == host reference on {len(docs)} docs, "
          f"{nbytes} bytes; {nbytes / mesh_s / 1e6:.3f} MB/s ({mesh_s:.3f} s); device_waves "
          f"{st['device_waves']}, device_pieces {st['device_pieces']}, unique_pieces "
          f"{st['unique_pieces']}, host_fallback_pieces {st['host_fallback_pieces']}, uploads "
          f"{st['device_uploads']} ({st['device_uploads'] / max(st['device_waves'], 1):.1f} a wave), "
          f"device_blocking_s {st['device_blocking_s']:.4f}; launches {launches}, by shard stream "
          f"{json.dumps([[d, hex(s), by_stream[(d, s)]] for d, s in shards])}, by device "
          f"{json.dumps(by_device)}; card {smi}", flush=True)

    # (c) the differential campaign's bodies on the card.
    spec = importlib.util.spec_from_file_location(
        "fuzz_campaign_torch", ROOT / "tools" / "fuzz_campaign_torch.py")
    campaign = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(campaign)
    iterations = {}
    for mode in ("encode", "trim", "threads", "mesh"):
        its, failure = campaign.run(mode, CAMPAIGN_SEED, CAMPAIGN_S, "cuda", log=lambda m: None)
        check(failure is None, f"phase 8 (c): {failure}")
        iterations[mode] = its
    print(f"phase 8 (c) campaign bodies on the card, seed {CAMPAIGN_SEED}, {CAMPAIGN_S:.0f} s "
          f"each, no mismatch: iterations {json.dumps(iterations)}", flush=True)
    return {"launches": launches, "MBps": nbytes / mesh_s / 1e6, "shards": len(devices)}


def forced(tok):
    """Every wave of ``tok`` onto the merge kernel, however small."""
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    return tok


def fresh_words(rng, n: int) -> list:
    """``n`` random seven-letter words: each one piece, first seen here."""
    return ["".join(map(chr, 97 + rng.integers(0, 26, size=7))) for _ in range(n)]


def word_soup(rng, vocab: list, docs: int, words: int) -> list:
    """``docs`` documents of ``words`` words drawn from ``vocab``, each with
    a CJK word and a number."""
    out = []
    for d in range(docs):
        picks = rng.integers(0, len(vocab), size=words)
        cjk = "".join(map(chr, rng.integers(0x4E00, 0x4E00 + 2000, size=4)))
        out.append(" ".join(vocab[p] for p in picks) + f" {cjk} {d * 7919}")
    return out


def assert_same(got, texts, host, what: str) -> None:
    check(len(got) == len(texts), f"{what}: {len(got)} outputs for {len(texts)} texts")
    for g, t in zip(got, texts):
        check(list(g) == host.encode(t), f"{what}: ids differ from the host engine for {t[:60]!r}")


def case_rotation(device, host) -> str:
    """A stream through max_unique_rows=600: the dedup generations rotate
    between its chunks while every chunk's wave is deferred on the card."""
    import numpy as np

    import tokenizer_tpu_torch as tt

    tok = forced(tt.create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, device=device, max_unique_rows=600))
    rng = np.random.default_rng(91)
    hot = fresh_words(rng, 200)  # in every chunk: resurrected after a rotation
    batches = [word_soup(rng, hot + fresh_words(rng, 600), 12, 60) for _ in range(8)]
    flat = [ids for b in tok.encode_batch_stream(iter(batches)) for ids in b]
    assert_same(flat, [t for b in batches for t in b], host, "rotation stream")
    st = tok.stats
    check(st.dedup_resets >= 2 and st.dedup_gen_copies > 0 and st.device_waves >= len(batches),
          f"rotation stream: {st.dedup_resets} rotations, {st.dedup_gen_copies} row copies, "
          f"{st.device_waves} device waves")
    return f"{st.dedup_resets} rotations, {st.dedup_gen_copies} row copies, {st.device_waves} waves"


def case_abandoned(device, host) -> str:
    """A stream closed after its first chunk while the next chunk's wave is
    deferred on the card; the same tokenizer then encodes a batch of that
    chunk's pieces."""
    import numpy as np

    import tokenizer_tpu_torch as tt

    tok = forced(tt.create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, device=device, max_unique_rows=600))
    rng = np.random.default_rng(92)
    vocabs = [fresh_words(rng, 400) for _ in range(5)]
    batches = [word_soup(rng, v, 30, 20) for v in vocabs]
    gen = tok.encode_batch_stream(iter(batches))
    assert_same(next(gen), batches[0], host, "abandoned stream, chunk 0")
    check(tok._stream_inflight == 1, f"no chunk deferred after chunk 0 ({tok._stream_inflight})")
    gen.close()
    check(tok._stream_inflight == 0, f"the closed stream left {tok._stream_inflight} chunks held")
    after = word_soup(rng, vocabs[1] + fresh_words(rng, 100), 40, 20)
    assert_same(tok.encode_batch(after), after, host, "batch after the closed stream")
    return f"{tok.stats.device_waves} waves"


def case_interleaved(device, host) -> str:
    """encode_batch and encode_trim_suffix_batch between the chunks of a live
    stream, each on pieces first seen in the chunk deferred at that moment."""
    import numpy as np

    import tokenizer_tpu_torch as tt

    tok = forced(tt.create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, device=device, max_unique_rows=600))
    rng = np.random.default_rng(93)
    vocabs = [fresh_words(rng, 300) for _ in range(7)]
    batches = [word_soup(rng, v, 40, 8) for v in vocabs[:6]]
    held = 0
    out = []
    for k, got in enumerate(tok.encode_batch_stream(iter(batches))):
        out.append(got)
        held += tok._stream_inflight
        side = word_soup(rng, vocabs[k + 1], 50, 6)  # chunk k + 1 is deferred now
        assert_same(tok.encode_batch(side), side, host, f"batch between chunks {k} and {k + 1}")
        for t, res in zip(side, tok.encode_trim_suffix_batch(side, 7)):
            check((res.token_ids, res.text) == tuple(host.encode_trim_suffix(t, 7)),
                  f"trim between chunks {k} and {k + 1} differs for {t[:60]!r}")
    assert_same([ids for b in out for ids in b], [t for b in batches for t in b], host,
                "interleaved stream")
    check(held == len(batches) - 1, f"{held} of {len(batches)} yields had a chunk deferred")
    check(tok._stream_inflight == 0, "the stream left a chunk held")
    return f"{held} yields with a chunk deferred, {tok.stats.device_waves} waves"


def case_flip(device, host) -> str:
    """Chunks deferred on the card, each followed by a host-routed emit chunk
    that repeats its pieces (the router set as the JAX tests set it)."""
    import numpy as np

    import tokenizer_tpu_torch as tt

    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device, mesh=None)
    tok._dev_pp, tok._host_pp, tok._news_per_byte = 1e-12, 1.0, 1.0
    rng = np.random.default_rng(94)
    batches = []
    for _ in range(3):
        words = fresh_words(rng, 1400)
        batches.append([" ".join(words)])
        batches.append([" ".join(words[:40]) + " fresh bits"])
    got = [ids for b in tok.encode_batch_stream(iter(batches)) for ids in b]
    assert_same(got, [b[0] for b in batches], host, "flip stream")
    st = tok.stats
    check(st.device_waves >= 3 and st.fused_pieces > 0,
          f"flip stream: device_waves {st.device_waves}, fused_pieces {st.fused_pieces}")
    return f"{st.device_waves} device waves, {st.fused_pieces} pieces fused on the host"


def case_threads(device, host) -> str:
    """Four threads encoding, trimming, decoding and streaming on one
    tokenizer (max_unique_rows=600), drawing on one vocabulary."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import tokenizer_tpu_torch as tt

    tok = forced(tt.create_by_encoder_name(
        "cl100k_synth", allow_fetch=False, device=device, max_unique_rows=600, mesh=None))
    vocab = fresh_words(np.random.default_rng(95), 3000)

    def work(seed):
        r = random.Random(seed)
        rng = np.random.default_rng(seed)
        for _ in range(6):
            docs = word_soup(rng, vocab, r.randint(2, 12), r.randint(5, 60))
            got = tok.encode_batch(docs)
            assert_same(got, docs, host, f"thread {seed} batch")
            check(tok.decode_batch(got) == docs, f"thread {seed}: decode_batch differs")
            for t, res in zip(docs, tok.encode_trim_suffix_batch(docs, 5)):
                check((res.token_ids, res.text) == tuple(host.encode_trim_suffix(t, 5)),
                      f"thread {seed}: trim differs for {t[:60]!r}")
            more = word_soup(rng, vocab, 6, 40)
            flat = [ids for b in tok.encode_batch_stream([more[:3], more[3:]]) for ids in b]
            assert_same(flat, more, host, f"thread {seed} stream")
        return True

    with ThreadPoolExecutor(max_workers=4) as ex:
        check(all(ex.map(work, range(4))), "a thread failed")
    return f"{tok.stats.device_waves} waves, {tok.stats.dedup_resets} rotations"


#: phase 9 (c): the cases with waves in flight, cl100k_synth, every wave forced.
IN_FLIGHT = {
    "rotation": case_rotation,
    "abandoned": case_abandoned,
    "interleaved": case_interleaved,
    "flip": case_flip,
    "threads": case_threads,
}

#: phase 9 (a): each vocabulary the port serves offline, its lib.rs.txt golden.
GOLDENS = {
    "gpt2": "tokens_gpt2.json",
    "r50k_base": "tokens_r50k_base.json",
    "p50k_base": "tokens_p50k_base.json",
    "p50k_edit": "tokens_p50k_edit.json",
    "cl100k_synth": "tokens_cl100k_synth.json",
    "o200k_synth": "tokens_o200k_synth.json",
}


def parity_phase(toks: dict, docs: list, nbytes: int, seed_text: str, device, smi: str) -> dict:
    """Phase 9, parity on the card; returns its launches and the o200k_synth
    stream's MB/s."""
    import numpy as np
    import torch

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.ops import merge_cuda

    merge_cuda.LAUNCHES = merge_cuda.V1_LAUNCHES = 0
    # (a) the goldens, every wave forced.
    for name, golden in GOLDENS.items():
        if name not in toks:
            toks[name] = tt.create_by_encoder_name(name, allow_fetch=False, device=device)
        tok = forced(toks[name])
        tok._reset_dedup_full()
        before = merge_cuda.LAUNCHES
        (ids,) = tok.encode_batch([seed_text])
        torch.cuda.synchronize()
        want = json.loads((ROOT / "tests" / "testdata" / golden).read_text())
        check(list(ids) == want, f"phase 9 (a) {name}: {len(ids)} ids differ from {golden}")
        check(tok.decode(ids) == seed_text, f"phase 9 (a) {name}: decode does not round-trip")
        check(merge_cuda.LAUNCHES > before, f"phase 9 (a) {name}: no launch")
        print(f"phase 9 (a) {name} lib.rs.txt == {golden} ({len(ids)} ids), decode round-trips; "
              f"launches {merge_cuda.LAUNCHES - before}", flush=True)

    # (b) o200k_synth end to end: phase 5's cold corpus, forced.
    tok = toks["o200k_synth"]
    tok._reset_dedup_full()
    st0 = tok.stats.as_dict()
    chunks = [docs[i : i + CHUNK_DOCS] for i in range(0, len(docs), CHUNK_DOCS)]
    before = merge_cuda.LAUNCHES
    t0 = time.perf_counter()
    out = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches_b = merge_cuda.LAUNCHES - before
    st = {k: v - st0[k] for k, v in tok.stats.as_dict().items()}
    ref = host_reference("o200k_synth")
    t0 = time.perf_counter()
    want = ref.encode_batch(docs)
    ref_s = time.perf_counter() - t0
    check(ref.stats.device_pieces == 0, "the o200k_synth reference used a device")
    check(len(out) == len(docs), f"o200k_synth stream gave {len(out)} outputs for {len(docs)} docs")
    bad = [i for i, (g, w) in enumerate(zip(out, want)) if not np.array_equal(g, w)]
    check(not bad, f"phase 9 (b) o200k_synth: {len(bad)} documents differ, first {bad[:5]}")
    check(launches_b > 0 and st["device_pieces"] > 0 and st["host_wave_pieces"] == 0,
          f"phase 9 (b): launches {launches_b}, device_pieces {st['device_pieces']}, "
          f"host_wave_pieces {st['host_wave_pieces']}")
    print(f"phase 9 (b) o200k_synth forced encode_batch_stream == host reference on {len(docs)} "
          f"docs, {nbytes} bytes, {sum(len(w) for w in want)} tokens; {nbytes / stream_s / 1e6:.3f} "
          f"MB/s ({stream_s:.3f} s; host-routed reference {nbytes / ref_s / 1e6:.3f} MB/s); "
          f"device_waves {st['device_waves']}, device_pieces {st['device_pieces']}, unique_pieces "
          f"{st['unique_pieces']}, host_fallback_pieces {st['host_fallback_pieces']}, "
          f"device_blocking_s {st['device_blocking_s']:.4f}; launches {launches_b}; card {smi}",
          flush=True)

    # (c) waves in flight, each case against the host engine.
    host = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=None)
    for name, case in IN_FLIGHT.items():
        before = merge_cuda.LAUNCHES
        t0 = time.perf_counter()
        what = case(device, host)
        torch.cuda.synchronize()
        check(merge_cuda.LAUNCHES > before, f"phase 9 (c) {name}: no launch")
        print(f"phase 9 (c) {name} == host engine: {what}; launches {merge_cuda.LAUNCHES - before} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    check(merge_cuda.V1_LAUNCHES == 0, "phase 9 launched the first merge kernel")
    return {"launches": merge_cuda.LAUNCHES, "o200k_MBps": nbytes / stream_s / 1e6,
            "o200k_ref_MBps": nbytes / ref_s / 1e6}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()
    check((ROOT / "tokenizer_tpu_torch").is_dir(), f"no tokenizer_tpu_torch beside {__file__}")
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    # Native scanner and parsed-vocabulary caches stay inside the checkout.
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(ROOT / "build" / "tokenizer_tpu_cache"))

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.runtime import build

    # -- 1. device ---------------------------------------------------------
    device = torch.device("cuda", 0)
    smi = smi_line()
    print(f"phase 1 torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    toks = {"gpt2": tt.create_by_encoder_name("gpt2", allow_fetch=False, device=device)}
    check(toks["gpt2"]._native is not None, "the native C++ scanner did not build (g++ missing?)")
    print(f"phase 1 native scanner ready ({time.perf_counter() - t0:.2f} s incl. g++ build "
          "and the gpt2 tokenizer)", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, report = build.build_library()
    build.load_library()
    print(f"phase 2 nvcc build {time.perf_counter() - t0:.2f} s -> {lib_path.relative_to(ROOT)}", flush=True)
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "wgmma" in line or "setmaxnreg" in line:
            print(f"phase 2 ptxas: {line.strip()}", flush=True)

    # -- 3. kernel vs plain on the card -------------------------------------
    seed_text = (ROOT / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    rng = np.random.default_rng(args.seed)
    sample = gen_corpus(1.0, args.seed + 1, seed_text)
    k_res = {}
    for name in TABLES:
        t0 = time.perf_counter()
        if name not in toks:
            toks[name] = tt.create_by_encoder_name(name, allow_fetch=False, device=device)
        table = toks[name].table
        print(f"phase 3 {name}: {table.n_pairs} pairs, 2^{table.slot_bits} slots, "
              f"max_probes {table.max_probes} ({time.perf_counter() - t0:.2f} s to build)", flush=True)
        k_res[name] = kernel_vs_plain(
            toks[name], bucket_pieces(toks[name], sample, rng, TILE_B), device, rng
        )
    docs = gen_corpus(CORPUS_MB, args.seed, seed_text)  # phase 5's corpus
    t0 = time.perf_counter()
    long_res = long_vs_host(toks["cl100k_synth"], long_pieces(toks["cl100k_synth"], docs),
                            device, rng, smi)
    print(f"phase 3 long rows {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 4. main path, gpt2 golden -----------------------------------------
    merge_cuda.LAUNCHES = merge_cuda.V1_LAUNCHES = 0
    gpt2 = forced(tt.create_by_encoder_name("gpt2", allow_fetch=False, device=device))
    golden = json.loads((ROOT / "tests" / "testdata" / "tokens_gpt2.json").read_text())
    (ids,) = gpt2.encode_batch([seed_text])
    torch.cuda.synchronize()
    check(list(ids) == golden, f"gpt2 lib.rs.txt: {len(ids)} ids differ from the golden")
    launches_gpt2 = merge_cuda.LAUNCHES
    check(launches_gpt2 > 0 and gpt2.stats.device_pieces > 0,
          f"gpt2 main path did not reach the kernel ({launches_gpt2} launches)")
    print(f"phase 4 gpt2 lib.rs.txt == golden ({len(ids)} ids); launches {launches_gpt2}, "
          f"device_pieces {gpt2.stats.device_pieces}", flush=True)

    # -- 5. main path, cl100k_synth cold stream -----------------------------
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    tok = forced(tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device))
    tok._ensure_device()  # table upload outside the timed region
    chunks = [docs[i : i + CHUNK_DOCS] for i in range(0, len(docs), CHUNK_DOCS)]
    before = merge_cuda.LAUNCHES
    t0 = time.perf_counter()
    out = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    st = tok.stats.as_dict()  # the stream's own counters, before the trims
    stream_launches = merge_cuda.LAUNCHES - before
    check(stream_launches > 0 and st["device_pieces"] > 0, "cl100k_synth stream did not reach the kernel")
    check(st["device_long_pieces"] > 0,
          f"cl100k_synth stream merged no piece over {BUCKETS[-1]} bytes on the card")

    ref = host_reference("cl100k_synth")
    t0 = time.perf_counter()
    want = ref.encode_batch(docs)
    ref_s = time.perf_counter() - t0
    check(ref.stats.device_pieces == 0, "the reference tokenizer used a device")
    check(len(out) == len(docs), f"stream gave {len(out)} outputs for {len(docs)} documents")
    bad = [i for i, (g, w) in enumerate(zip(out, want)) if not np.array_equal(g, w)]
    check(not bad, f"cl100k_synth: {len(bad)} documents differ, first {bad[:5]}")
    n_tokens = sum(len(w) for w in want)
    print(f"phase 5 cl100k_synth stream == host reference on {len(docs)} docs, {nbytes} bytes, "
          f"{n_tokens} tokens", flush=True)

    fresh = gen_corpus(0.3, args.seed + 2, seed_text)[:64]
    budgets = [int(b) for b in rng.integers(1, 2000, size=len(fresh))]
    trims = tok.encode_trim_suffix_batch(fresh, budgets)
    for d, b, res in zip(fresh, budgets, trims):
        check((res.token_ids, res.text) == tuple(ref.encode_trim_suffix(d, b)), "trim-suffix differs")
    for d, res in zip(fresh, tok.encode_trim_prefix_batch(fresh, 64)):
        check((res.token_ids, res.text) == tuple(ref.encode_trim_prefix(d, 64)), "trim-prefix differs")
    fresh_ids = tok.encode_batch([d + " tail" for d in fresh])
    check(tok.decode_batch(fresh_ids) == [d + " tail" for d in fresh], "decode_batch differs")
    torch.cuda.synchronize()
    launches = merge_cuda.LAUNCHES
    check(merge_cuda.V1_LAUNCHES == 0,
          f"the main path launched the first merge kernel {merge_cuda.V1_LAUNCHES} times")
    print(f"phase 5 trims (suffix, prefix) and decode_batch == reference on {len(fresh)} docs", flush=True)
    print(f"phase 5 cold encode_batch_stream {nbytes / cold_s / 1e6:.3f} MB/s ({cold_s:.3f} s; "
          f"host-routed reference {nbytes / ref_s / 1e6:.3f} MB/s); stream: device_waves "
          f"{st['device_waves']}, device_pieces {st['device_pieces']}, unique_pieces "
          f"{st['unique_pieces']}, pieces over {BUCKETS[-1]} bytes merged on the card "
          f"(device_long_pieces) {st['device_long_pieces']}, host_fallback_pieces "
          f"{st['host_fallback_pieces']}, "
          f"device_blocking_s {st['device_blocking_s']:.4f}, launches {stream_launches}; "
          f"main-path launches in all {launches} (gpt2 {launches_gpt2}); card {smi}", flush=True)

    # -- 6. probe experiments (K3, K4, K5) ----------------------------------
    from tokenizer_tpu_torch.ops import exp_probe, probe_cuda

    t6 = time.perf_counter()
    l2 = probe_cuda.l2_limits(device)
    print(f"phase 6 L2 limits {json.dumps(l2)}", flush=True)
    errs = {name: probe_vs_plain(toks[name].table, name, device, rng) for name in k_res}
    tiles = (exp_probe.SHAPE, exp_probe.BIG_SHAPE)
    probe_cuda.ASYNC_LAUNCHES = probe_cuda.RESIDENT_LAUNCHES = probe_cuda.ONEHOT_LAUNCHES = 0
    arms = {name: exp_probe.run_arms(toks[name].table, device) for name in k_res}
    big = {name: exp_probe.run_arms(toks[name].table, device, exp_probe.BIG_SHAPE,
                                    arms=exp_probe.ROW_ARMS) for name in k_res}
    torch.cuda.synchronize()
    probe_launches = dict(zip(PROBE_KERNELS, (
        probe_cuda.ASYNC_LAUNCHES, probe_cuda.RESIDENT_LAUNCHES, probe_cuda.ONEHOT_LAUNCHES,
    )))
    # per table, tile and arm: the run_arms record
    by_tile = {name: {tile_key(rec["shape"]): {} for rec in arms[name] + big[name]} for name in k_res}
    for name in k_res:
        for rec in arms[name] + big[name]:
            by_tile[name][tile_key(rec["shape"])][rec["arm"]] = rec
            check(rec["bit_exact"] and rec["plain_bit_exact"],
                  f"{name} {rec['arm']}: not bit-exact against PairTable.lookup ({rec})")
            print(f"phase 6 run_arms {name} {rec['arm']} {rec['shape']}: bit-exact; kernel "
                  f"{rec['device_us']} us (queued); plain {rec['plain_ms']:.4f} ms (median of "
                  f"{exp_probe.REPS}, CUDA events), {rec['plain_device_us']} us of device "
                  "time (torch.profiler)",
                  flush=True)
    rows = {}  # K3 / K4 per table and tile: bound and window bytes
    for name in k_res:
        table = toks[name].table
        for tile in tiles:
            key = tile_key(tile)
            recs = by_tile[name][key]
            b_us, w_bytes = probe_bound_us(table, tile), window_bytes(table, tile)
            rows[(name, key)] = {"bound_us": b_us, "window_bytes": w_bytes}
            k1 = recs["lookup_pairs"]["device_us"]
            for arm in ("probe_rows_async", "probe_rows_resident"):
                us = recs[arm]["device_us"]
                print(f"phase 6 {arm} {name} {list(tile)}: {us:.3f} us (queued); byte bound "
                      f"{b_us:.4f} us, {b_us / us:.3%} of it; windows {w_bytes} bytes; K1's "
                      f"probe on the same tile {k1:.3f} us ({us / k1:.2f}x); card {smi}",
                      flush=True)
    for k, n in probe_launches.items():
        check(n > 0, f"the probe experiment's path did not launch {k}")
    check(probe_cuda.l2_limits(device)["persisting_l2_bytes"] == l2["persisting_l2_bytes"],
          "the persisting L2 set-aside was not given back after K4")
    k5 = {}
    for name, recs in arms.items():
        k5[name] = onehot_yardstick(toks[name].table, name, device)
        us = next(r for r in recs if r["arm"] == "lookup_onehot")["device_us"]
        lib_us, bound = k5[name]["library_ms"] * 1e3, k5[name]["ops_bound_us"]
        print(f"phase 6 K5 {name} {list(exp_probe.SHAPE)}: kernel {us:.3f} us (queued), ops bound "
              f"{bound:.3f} us ({k5[name]['ops']} int8 ops at 1,979 TOP/s): {bound / us:.2%} of it; "
              f"torch._int_mm on the same product {lib_us:.3f} us ({bound / lib_us:.2%}); kernel / "
              f"_int_mm {us / lib_us:.3f}; L2->SMEM {k5[name]['l2_to_smem_bytes']} bytes per call; "
              f"card {smi}", flush=True)
    print(f"phase 6 launches in run_arms {json.dumps(probe_launches)}; "
          f"{time.perf_counter() - t6:.2f} s; card {smi}", flush=True)

    # -- 7. corpus path ------------------------------------------------------
    t7 = time.perf_counter()
    corpus = corpus_phase(args.seed, seed_text, device, smi)
    print(f"phase 7 {time.perf_counter() - t7:.2f} s", flush=True)

    # -- 8. multi-device path --------------------------------------------------
    t8 = time.perf_counter()
    mesh = mesh_phase(docs, want, nbytes, smi)
    print(f"phase 8 {time.perf_counter() - t8:.2f} s", flush=True)

    # -- 9. parity on the card ---------------------------------------------------
    t9 = time.perf_counter()
    parity = parity_phase(toks, docs, nbytes, seed_text, device, smi)
    print(f"phase 9 {time.perf_counter() - t9:.2f} s; card {smi}", flush=True)
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "bench", "tokenizer_tpu") or m.startswith("tokenizer_tpu."))
    check(not leaked, f"imported {leaked}")

    ns = k_res["cl100k_synth"]
    kernel = {
        "name": KERNEL,
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "also_replaces": ALSO_REPLACES,
        "launches": launches + corpus["launches"] + mesh["launches"] + parity["launches"],
        "launches_by_path": {
            "encode_batch + encode_batch_stream (phases 4-5)": launches,
            "encode_corpus (phase 7a)": corpus["launches"],
            "mesh (phase 8)": mesh["launches"],
            "parity (phase 9)": parity["launches"],
        },
        "max_abs_err": max([r["max_abs_err"] for r in k_res.values()] + [long_res["max_abs_err"]]),
        # one [L, 8192] tile of each bucket, cl100k_synth table, summed;
        # ms: device time (exp_probe.queued_ms), plain_ms: CUDA events
        "ms": sum(ns["ms"].values()),
        "plain_ms": sum(ns["plain_ms"].values()),
        "bound_ms": sum(ns["bound_us"].values()) / 1e3,
        "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call computes the merge
        "ms_by_bucket": {f"{v}/L{L}": r["ms"][L] for v, r in k_res.items() for L in BUCKETS},
        "v1_ms_by_bucket": {f"{v}/L{L}": r["v1_ms"][L] for v, r in k_res.items() for L in BUCKETS},
        "plain_ms_by_bucket": {f"{v}/L{L}": r["plain_ms"][L] for v, r in k_res.items() for L in BUCKETS},
        "bound_us_by_bucket": {f"{v}/L{L}": r["bound_us"][L] for v, r in k_res.items() for L in BUCKETS},
        # phase 3's long rows, cl100k_synth: [L, B] tiles of the corpus's
        # long pieces; host_ms: the native bpe_encode_batch_spans on them
        "long_ms_by_tile": long_res["ms"],
        "long_plain_ms_by_tile": long_res["plain_ms"],
        "long_bound_us_by_tile": long_res["bound_us"],
        "long_host_ms_by_tile": long_res["host_ms"],
        "long_merges_by_tile": long_res["merges"],
        "stream_device_long_pieces": st["device_long_pieces"],
        "cold_stream_MBps": nbytes / cold_s / 1e6,
        "corpus_MBps": corpus["MBps"],
        "corpus_host_reference_MBps": corpus["ref_MBps"],
        "mesh_stream_MBps": mesh["MBps"],
        "o200k_synth_stream_MBps": parity["o200k_MBps"],
        "o200k_synth_host_reference_MBps": parity["o200k_ref_MBps"],
        "mesh_shards": mesh["shards"],
    }
    probes = []
    for arm, source, replaces in exp_probe.ARMS:
        if arm not in probe_launches:
            continue  # the merge kernel's own probe, reported above
        by_table = {name: by_tile[name][tile_key(exp_probe.SHAPE)][arm] for name in arms}
        bounds = {name: rows[(name, tile_key(exp_probe.SHAPE))]["bound_us"] for name in by_table}
        probes.append({
            "name": arm,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": probe_launches[arm],
            "max_abs_err": max(e[arm] for e in errs.values()),
            # run_arms' [16, 128] tile, cl100k_synth table; ms: device
            # time (exp_probe.queued_ms), plain_ms: CUDA events; K5's
            # bound and library call are set below
            "ms": by_table["cl100k_synth"]["device_us"] / 1e3,
            "plain_ms": by_table["cl100k_synth"]["plain_ms"],
            "bound_ms": bounds["cl100k_synth"] / 1e3,
            "bound_by": "bytes",
            "library_ms": None,  # no PyTorch call computes a hash-table lookup
            "bound_us_by_table": bounds,
            "plain_ms_by_table": {name: r["plain_ms"] for name, r in by_table.items()},
            "device_us_by_table": {name: r["device_us"] for name, r in by_table.items()},
            "plain_device_us_by_table": {
                name: r["plain_device_us"] for name, r in by_table.items()
            },
        })
        if arm == "lookup_onehot":
            # K5 does the one-hot product of every round and byte plane:
            # 2 M K N int8 operations bound it, and torch._int_mm computes
            # the same product.
            probes[-1].update({
                "bound_ms": k5["cl100k_synth"]["ops_bound_us"] / 1e3,
                "bound_by": "operations",
                "library_ms": k5["cl100k_synth"]["library_ms"],
                "library_call": "torch._int_mm(one_hot [M, K] int8, tab_k.t() [K, N] int8)",
                "bound_us_by_table": {n: r["ops_bound_us"] for n, r in k5.items()},
                "lookup_bytes_bound_us_by_table": bounds,
                "library_ms_by_table": {n: r["library_ms"] for n, r in k5.items()},
                "l2_to_smem_bytes_by_table": {n: r["l2_to_smem_bytes"] for n, r in k5.items()},
            })
        else:
            # Both tiles; the windows are the bytes this formulation moves.
            per = {name: {tile_key(t): by_tile[name][tile_key(t)] for t in tiles} for name in arms}
            probes[-1].update({
                "device_us_by_table_and_tile": {
                    name: {k: r[arm]["device_us"] for k, r in t.items()} for name, t in per.items()},
                "plain_device_us_by_table_and_tile": {
                    name: {k: r[arm]["plain_device_us"] for k, r in t.items()}
                    for name, t in per.items()},
                "bound_us_by_table_and_tile": {
                    name: {k: rows[(name, k)]["bound_us"] for k in t} for name, t in per.items()},
                "window_bytes_by_table": {
                    name: {k: rows[(name, k)]["window_bytes"] for k in t} for name, t in per.items()},
                "lookup_pairs_us_by_table_and_tile": {
                    name: {k: r["lookup_pairs"]["device_us"] for k, r in t.items()}
                    for name, t in per.items()},
            })
    print(f"chip_smoke passed every phase in {time.perf_counter() - t_start:.2f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel, *probes]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
