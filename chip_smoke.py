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
3. kernel vs plain: for the gpt2 and cl100k_synth pair tables, one
   ``[L, 8192]`` tile of real corpus pieces per packer bucket L goes
   through the CUDA merge kernel (warp per column), the port's first merge
   kernel (thread per column) and the plain PyTorch version on the card
   (all equal, exactly) and through the native C++ heap merge on the host
   (1024 columns); the probe kernel is held to ``PairTable.lookup`` on
   65,536 pairs.  Each kernel's device time (launches queued behind a
   sleep kernel, CUDA events; the plain merge by CUDA events around each
   call) is set beside the tile's bound: its bytes over 3.35 TB/s, the
   tile in and out and the table bytes of the distinct pairs the plain
   merge had to probe, each slot once (``table_bytes``);
4. main path, gpt2: ``encode_batch`` of ``tests/testdata/lib.rs.txt`` with
   every wave forced onto the card must give the 11,378 golden ids;
5. main path, cl100k_synth: an ~8 MB cold corpus made from ``--seed``
   streams through ``encode_batch_stream`` in 256-document chunks and must
   equal, document for document, a host-routed tokenizer of the same
   vocabulary (every wave merged by the native C++ heap merge, no card);
   bulk trims and decode are checked on 64 fresh documents;
6. probe experiments, on the tables of phase 3: the row-copy (K3), the
   L2-resident row (K4) and the one-hot int8 tensor-core (K5) probe
   kernels equal their plain PyTorch versions on a ``[16, 128]`` tile and
   ``PairTable.lookup`` on 65,536 pairs; then the experiment's own path,
   ``exp_probe.run_arms`` (``tools/exp_cuda_probe.py``), runs every arm
   on both tables, bit-exact, with kernel and plain times.

The merge kernels' launch counts are reset before phase 4 and read after
phase 5 (the first merge kernel must not be launched there); the probe
kernels' counts are reset just before ``run_arms`` and read after it.
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
HOST_COLS = 1024
LOOKUP_PAIRS = 65536
CHUNK_DOCS = 256
CORPUS_MB = 8.0
REPS = 5
KERNEL = "merge_packed"
KERNEL_SOURCE = "tokenizer_tpu_torch/csrc/merge_packed.cu"
REPLACES = "tokenizer_tpu/ops/merge_pallas.py:213"  # and merge_jax.py:83
PROBE_KERNELS = ("probe_rows_async", "probe_rows_resident", "lookup_onehot")  # K3, K4, K5
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
        probed = []  # every pair the merge needs, as left << 32 | right

        def on_probe(left, right):
            ok = (left >= 0) & (right >= 0)
            probed.append((left[ok].long() << 32) | right[ok].long())

        p_ids, p_n = merge_packed_torch(tab, di, dl, **kw, on_probe=on_probe)
        keys = torch.unique(torch.cat(probed)).cpu().numpy()
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
        tile_bytes = 2 * ids.nbytes + 2 * lengths.nbytes
        tab_bytes, n_pairs = table_bytes(table, keys >> 32, keys & 0xFFFFFFFF)
        b_us = bound_us(tile_bytes + tab_bytes)
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


def probe_bound_us(table) -> float:
    """The bound of phase 6's [16, 128] lookup: the pairs in and the
    ids out, and the table bytes its distinct valid pairs read."""
    from tokenizer_tpu_torch.ops import exp_probe

    left, right = exp_probe.make_probes(table, exp_probe.SHAPE)
    return bound_us(3 * left.nbytes + table_bytes(table, left, right)[0])


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
        if "registers" in line or "spill" in line:
            print(f"phase 2 ptxas: {line.strip()}", flush=True)

    # -- 3. kernel vs plain on the card -------------------------------------
    seed_text = (ROOT / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    rng = np.random.default_rng(args.seed)
    sample = gen_corpus(1.0, args.seed + 1, seed_text)
    k_res = {}
    for name in ("gpt2", "cl100k_synth"):
        t0 = time.perf_counter()
        if name not in toks:
            toks[name] = tt.create_by_encoder_name(name, allow_fetch=False, device=device)
        table = toks[name].table
        print(f"phase 3 {name}: {table.n_pairs} pairs, 2^{table.slot_bits} slots, "
              f"max_probes {table.max_probes} ({time.perf_counter() - t0:.2f} s to build)", flush=True)
        k_res[name] = kernel_vs_plain(
            toks[name], bucket_pieces(toks[name], sample, rng, TILE_B), device, rng
        )

    # -- 4. main path, gpt2 golden -----------------------------------------
    merge_cuda.LAUNCHES = merge_cuda.V1_LAUNCHES = 0
    gpt2 = tt.create_by_encoder_name("gpt2", allow_fetch=False, device=device)
    gpt2._host_pp = float("inf")  # force every wave onto the card
    gpt2._host_wave_max = 0
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
    docs = gen_corpus(CORPUS_MB, args.seed, seed_text)
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=device)
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
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

    # The reference: every wave to the native C++ heap merge, no card.
    ref = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu")
    ref._host_wave_max = sys.maxsize
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
          f"{st['unique_pieces']}, host_fallback_pieces {st['host_fallback_pieces']}, "
          f"device_blocking_s {st['device_blocking_s']:.4f}, launches {stream_launches}; "
          f"main-path launches in all {launches} (gpt2 {launches_gpt2}); card {smi}", flush=True)

    # -- 6. probe experiments (K3, K4, K5) ----------------------------------
    from tokenizer_tpu_torch.ops import exp_probe, probe_cuda

    t6 = time.perf_counter()
    l2 = probe_cuda.l2_limits(device)
    print(f"phase 6 L2 limits {json.dumps(l2)}", flush=True)
    errs = {name: probe_vs_plain(toks[name].table, name, device, rng) for name in k_res}
    probe_cuda.ASYNC_LAUNCHES = probe_cuda.RESIDENT_LAUNCHES = probe_cuda.ONEHOT_LAUNCHES = 0
    arms = {name: exp_probe.run_arms(toks[name].table, device) for name in k_res}
    torch.cuda.synchronize()
    probe_launches = dict(zip(PROBE_KERNELS, (
        probe_cuda.ASYNC_LAUNCHES, probe_cuda.RESIDENT_LAUNCHES, probe_cuda.ONEHOT_LAUNCHES,
    )))
    for name, recs in arms.items():
        for rec in recs:
            check(rec["bit_exact"] and rec["plain_bit_exact"],
                  f"{name} {rec['arm']}: not bit-exact against PairTable.lookup ({rec})")
            print(f"phase 6 run_arms {name} {rec['arm']} {rec['shape']}: bit-exact; kernel "
                  f"{rec['device_us']} us (queued); plain {rec['plain_ms']:.4f} ms (median of "
                  f"{exp_probe.REPS}, CUDA events), {rec['plain_device_us']} us of device "
                  "time (torch.profiler)",
                  flush=True)
    for k, n in probe_launches.items():
        check(n > 0, f"the probe experiment's path did not launch {k}")
    check(probe_cuda.l2_limits(device)["persisting_l2_bytes"] == l2["persisting_l2_bytes"],
          "the persisting L2 set-aside was not given back after K4")
    print(f"phase 6 launches in run_arms {json.dumps(probe_launches)}; "
          f"{time.perf_counter() - t6:.2f} s; card {smi}", flush=True)
    leaked = sorted(m for m in sys.modules
                    if m in ("jax", "bench", "tokenizer_tpu") or m.startswith("tokenizer_tpu."))
    check(not leaked, f"imported {leaked}")

    ns = k_res["cl100k_synth"]
    kernel = {
        "name": KERNEL,
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k_res.values()),
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
        "cold_stream_MBps": nbytes / cold_s / 1e6,
    }
    probes = []
    for arm, source, replaces in exp_probe.ARMS:
        if arm not in probe_launches:
            continue  # the merge kernel's own probe, reported above
        by_table = {name: next(r for r in recs if r["arm"] == arm) for name, recs in arms.items()}
        bounds = {name: probe_bound_us(toks[name].table) for name in by_table}
        probes.append({
            "name": arm,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": probe_launches[arm],
            "max_abs_err": max(e[arm] for e in errs.values()),
            # run_arms' [16, 128] tile, cl100k_synth table; ms: device
            # time (exp_probe.queued_ms), plain_ms: CUDA events
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
            # K5's formulation, not the lookup: the one-hot int8 products
            # of every round and byte plane at the int8 peak.
            probes[-1]["onehot_ops_bound_us_by_table"] = {
                name: 2 * exp_probe.SHAPE[0] * 128 * toks[name].table.max_probes
                * toks[name].table.n_slots * 3 * 4 / INT8_OPS_PER_S * 1e6
                for name in by_table
            }
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
