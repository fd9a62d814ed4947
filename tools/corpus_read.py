#!/usr/bin/env python3
"""The corpus cell's files walked and read each way, in turns: where the read's time goes.

    python3 tools/corpus_read.py [--mb 64] [--seed 0] [--rounds 3] [--dir DIR] [--out FILE]

Writes the files of the benchmark's corpus cell as ``bench_torch.corpus_cell``
writes them (``chip_smoke.gen_corpus(mb, seed, bench_torch.seed_text())``,
one ``doc%06d.txt`` a document) into ``DIR/corpus`` (default
``build/bench/corpus_read``, beside the cell's own files), and the same
bytes into one file, ``DIR/one.txt``.  Each round then times, in this
order (in reverse every other round):

- ``walk_rglob``: the JAX package's walk, ``rglob("*")``, ``is_file`` on
  each path, ``sorted``;
- ``walk_scandir``: the port's walk, ``pipeline.corpus_files`` (one
  ``scandir`` a directory, the entry's type, no ``stat`` a file);
- ``read_text``: ``Path.read_text(encoding="utf-8", errors="replace")``
  of every file, the JAX package's read;
- ``read_raw``: the port's read, ``pipeline.read_text`` (``open``,
  ``read`` until no bytes, ``close``, decode) of every file;
- ``read_raw_t2``, ``_t4``, ``_t8``: ``read_raw`` on 2, 4 and 8 threads,
  in order (for the record: the pipeline reads on one thread);
- ``one_file``: ``read_raw`` of ``one.txt``.

Both walks must give the same files and both reads the same texts, equal
to the generated documents.  It prints a line a variant and one JSON
record (the filesystem type of ``DIR`` from ``/proc/self/mountinfo``, the
host's cores, the card's name and power limit where ``nvidia-smi``
answers, each variant's seconds a round) and writes it to ``--out``.
Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THREADS = (2, 4, 8)


def fs_type(path: Path):
    """The type of the filesystem that holds ``path``: the longest mount
    point of ``/proc/self/mountinfo`` above it (None where unreadable)."""
    real, best = os.path.realpath(path), (-1, None)
    try:
        lines = Path("/proc/self/mountinfo").read_text().splitlines()
    except OSError:
        return None
    for line in lines:
        left, _, right = line.partition(" - ")
        mount = left.split()[4].replace("\\040", " ")
        inside = real == mount or real.startswith(mount.rstrip("/") + "/")
        if inside and len(mount) > best[0]:
            best = (len(mount), right.split()[0])
    return best[1]


def write_corpus(work: Path, mb: float, seed: int) -> list:
    from bench_torch import seed_text
    from chip_smoke import gen_corpus

    docs = gen_corpus(mb, seed, seed_text())
    shutil.rmtree(work, ignore_errors=True)
    (work / "corpus").mkdir(parents=True)
    for i, doc in enumerate(docs):
        (work / "corpus" / f"doc{i:06d}.txt").write_text(doc, encoding="utf-8")
    (work / "one.txt").write_text("".join(docs), encoding="utf-8")
    return docs


def variants(corpus: Path, one: Path) -> dict:
    """name -> a call that does the variant's whole work and returns its result."""
    from tokenizer_tpu_torch.runtime.pipeline import corpus_files, read_text

    files = corpus_files(str(corpus))

    def threaded(n):
        def run():
            with ThreadPoolExecutor(n) as pool:
                return list(pool.map(read_text, files))
        return run

    return {
        "walk_rglob": lambda: [str(f) for f in sorted(f for f in corpus.rglob("*") if f.is_file())],
        "walk_scandir": lambda: corpus_files(str(corpus)),
        "read_text": lambda: [Path(f).read_text(encoding="utf-8", errors="replace") for f in files],
        "read_raw": lambda: [read_text(f) for f in files],
        **{f"read_raw_t{n}": threaded(n) for n in THREADS},
        "one_file": lambda: read_text(str(one)),
    }


def measure(work: Path, mb: float, seed: int, rounds: int) -> dict:
    t0 = time.perf_counter()
    docs = write_corpus(work, mb, seed)
    write_s = time.perf_counter() - t0
    calls = variants(work / "corpus", work / "one.txt")
    seconds = {name: [] for name in calls}
    for r in range(rounds):
        for name in list(calls)[:: 1 if r % 2 == 0 else -1]:
            t0 = time.perf_counter()
            got = calls[name]()
            seconds[name].append(time.perf_counter() - t0)
            if name.startswith("walk"):
                want = [str(work / "corpus" / f"doc{i:06d}.txt") for i in range(len(docs))]
            else:
                want = "".join(docs) if name == "one_file" else docs
            if got != want:
                raise SystemExit(f"corpus_read FAILED: {name} differs from the written corpus")
    n = len(docs)
    out = {}
    for name, xs in seconds.items():
        med = statistics.median(xs)
        out[name] = {"seconds": xs, "median_s": med, "us_per_file": med / n * 1e6}
    walk_read = {k: [a + b for a, b in zip(seconds[w], seconds[rd])]
                 for k, w, rd in (("jax", "walk_rglob", "read_text"),
                                  ("port", "walk_scandir", "read_raw"))}
    return {"dir": str(work), "fs_type": fs_type(work), "cores": os.cpu_count(),
            "mb": mb, "seed": seed, "files": n,
            "bytes": sum(len(d.encode("utf-8")) for d in docs), "rounds": rounds,
            "write_s": write_s, "variants": out,
            "walk_plus_read_s": walk_read,
            "port_over_jax": statistics.median(walk_read["port"]) / statistics.median(walk_read["jax"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=64.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dir", type=Path, default=ROOT / "build" / "bench" / "corpus_read")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "corpus_read.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from ab_turns import smi

    record = measure(args.dir.resolve(), args.mb, args.seed, args.rounds)
    record["card"] = smi() if shutil.which("nvidia-smi") else None
    for name, v in record["variants"].items():
        print(f"{name}: median {v['median_s']:.4f} s, {v['us_per_file']:.1f} us a file, "
              f"rounds {[round(x, 4) for x in v['seconds']]}", flush=True)
    print(json.dumps(record), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
