"""Profile the PyTorch / CUDA port's cold cl100k_synth stream on one card.

Measures what chip_smoke.py does not: the spread of the cold stream's
MB/s over several rounds, and where one forced run spends its time.

1. Rounds.  The ~8 MB corpus of chip_smoke.py (``--seed``) streams in
   256-document chunks through fresh tokenizers on three routes, in a
   rotated order each round: ``forced`` (every wave merged by the CUDA
   kernel), ``default`` (the inherited routing: small waves stay on the
   host) and ``host`` (every wave merged by the native C++ heap merge).
   The forced tokenizer then streams the corpus again, warm.
2. One profiled forced run.  torch.profiler records the card's own
   activity; only device-side rows (kernels, memcpys, memsets) count,
   and the busy time is the union of their intervals, so nothing is
   counted twice.  Host time is wall-clock around the tokenizer's
   methods; the methods nest, so their times do not add up.

Usage, with one CUDA card visible, from the repository root:

  python3 tools/profile_torch_stream.py [--seed 0] [--rounds 4] [--out FILE]

``--out`` also writes the whole record as JSON.  jax is never imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ROUTES = ("forced", "default", "host")
#: methods timed in the profiled run (GpuTokenizer's host layers).
TIMED = (
    "_native_encode_emit",
    "_register_new_uids_arrays",
    "_dispatch_device_spans",
    "_dispatch_tiles",
    "_bucket_out",
    "_finish_span_rows",
    "_oracle_piece",
    "_backfill_patches",
)
#: device-side rows that are the profiler's own bookkeeping.
PROFILER_ROWS = ("Activity Buffer Request",)


def make(route: str):
    import tokenizer_tpu_torch as tt

    if route == "host":
        tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu")
        tok._host_wave_max = sys.maxsize
        return tok
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cuda")
    if route == "forced":
        tok._host_pp = float("inf")
        tok._host_wave_max = 0
    tok._ensure_device()  # table upload outside the timed region
    return tok


def stream_s(tok, chunks) -> float:
    import torch

    t0 = time.perf_counter()
    for _batch in tok.encode_batch_stream(chunks):
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def timed_methods(tok, acc: dict) -> None:
    """Wrap the instance's TIMED methods with wall-clocks."""

    def wrap(name, fn):
        def inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

        return inner

    for name in TIMED:
        setattr(tok, name, wrap(name, getattr(tok, name)))


def device_rows(prof) -> tuple:
    """(per-name rows, busy µs): device-side events only, busy as the
    union of their intervals."""
    from torch.autograd import DeviceType

    rows, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in PROFILER_ROWS:
            continue
        start, end = e.time_range.start, e.time_range.end
        r = rows.setdefault(e.name, {"count": 0, "us": 0.0})
        r["count"] += 1
        r["us"] += end - start
        spans.append((start, end))
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return rows, busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_stream: torch.cuda.is_available() is False")
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(REPO / "build" / "tokenizer_tpu_cache"))
    sys.path.insert(0, str(REPO))
    from chip_smoke import CHUNK_DOCS, CORPUS_MB, gen_corpus
    from tokenizer_tpu_torch.ops import merge_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    seed_text = (REPO / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    docs = gen_corpus(CORPUS_MB, args.seed, seed_text)
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    chunks = [docs[i : i + CHUNK_DOCS] for i in range(0, len(docs), CHUNK_DOCS)]
    print(f"card {smi}; corpus {len(docs)} docs, {nbytes} bytes, {len(chunks)} chunks", flush=True)

    stream_s(make("forced"), chunks)  # first launches and allocator, untimed
    mbps = {r: [] for r in (*ROUTES, "forced_warm")}
    stats = {}
    for i in range(args.rounds):
        order = ROUTES[i % 3 :] + ROUTES[: i % 3]
        for route in order[::-1] if i % 2 else order:
            tok = make(route)
            mbps[route].append(nbytes / stream_s(tok, chunks) / 1e6)
            stats[route] = tok.stats.as_dict()
            if route == "forced":
                mbps["forced_warm"].append(nbytes / stream_s(tok, chunks) / 1e6)
    for route, v in mbps.items():
        print(f"{route}: MB/s per round {v}, median {statistics.median(v)}", flush=True)
    for route, st in stats.items():
        print(f"stats {route} (last round, cold pass): {json.dumps(st)}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    tok = make("forced")
    acc = {}
    timed_methods(tok, acc)
    before = merge_cuda.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = stream_s(tok, chunks)
    launches = merge_cuda.LAUNCHES - before
    rows, busy_us = device_rows(prof)
    print(f"profiled forced run: wall {wall} s, {launches} launches; host methods (s): "
          f"{json.dumps(acc)}", flush=True)
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["us"]):
        print(f"device {name[:90]}: {r['count']} x, {r['us']} us", flush=True)
    print(f"device busy {busy_us} us of {wall * 1e6} us wall = {busy_us / (wall * 1e6)}", flush=True)

    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "bytes": nbytes, "mbps": mbps, "stats": stats,
            "profiled": {"wall_s": wall, "launches": launches, "host_s": acc,
                         "device_rows": rows, "busy_us": busy_us},
        }, indent=1))
    if "jax" in sys.modules:
        raise SystemExit("profile_torch_stream: jax was imported")
    return 0


if __name__ == "__main__":
    sys.exit(main())
