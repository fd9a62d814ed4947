#!/usr/bin/env python3
"""bench_torch.py on two trees in turns on one card, and the comparison.

    python3 tools/bench_turns.py --parent DIR --cell NAME [--rounds N] [--seed S] [--out FILE]
    python3 tools/bench_turns.py --summary FILE [FILE ...]

DIR is another tree of the repository, say ``git archive`` of the parent
commit unpacked under ``build/``.  Each round runs ``bench_torch.py --cell
NAME`` four times, each in a process of its own from its own tree (so each
imports its own ``tokenizer_tpu_torch`` and builds into its own
``build/``): DIR, this tree, this tree, DIR.  Invocations 1-2 and 3-4 of
a round are pairs, so each side runs first in half of them.  Both trees
must hold the same ``bench_torch.py`` and ``BENCHMARK.json`` (checked),
so both are measured by the same code at the same settings.

Per cell and metric (``cold_MBps``, ``warm_MBps``, the host-routed
``control_MBps``) it prints each side's median and quartiles over every
repetition, the invocations' medians, the pairs whose change invocation
had the higher median, and the ratio of the pooled medians; the router's
counters of each repetition (each distinct value of the ``GpuStats``
counts with how many repetitions had it, the medians of the seconds);
and the range over the traced repetitions of the wall, the host methods
(``host_s``) and the device metrics.  ``--out`` (default
``build/bench_turns.json``) gets the card's name and power limit, every
record and the summary, rewritten after each invocation.  ``--summary``
prints the summary of such files again, their runs taken together.  A
summary is per cell and seed, over paired invocations only: an
invocation without its partner (the run was cut) counts in none.  Needs
a card (bench_torch.py refuses without one).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from ab_turns import smi  # noqa: E402
from bench_torch import spread  # noqa: E402

ORDER = ("parent", "change", "change", "parent")
#: the traced repetition's single numbers reported per side.
TRACED = ("traced_wall_s", "device_busy_us", "device_idle_share", "k1_device_us")


def _span(xs: list):
    xs = [x for x in xs if x is not None]
    return [min(xs), max(xs)] if xs else None


def summarize(*files_runs: list) -> dict:
    """Each argument: one file's runs, [{"side", "record"}] in the order
    they ran.  Returns {"CELL seed N": {"metrics": ..., "router": ...,
    "traced": ...}}."""
    cells: dict = {}
    for runs in files_runs:
        groups: dict = {}
        for run in runs:
            rec = run["record"]
            groups.setdefault(f"{rec['cell']} seed {rec['seed']}", []).append(run)
        for key, rs in groups.items():
            cells.setdefault(key, []).extend(rs[: len(rs) - len(rs) % 2])
    out = {}
    for cell, rs in cells.items():
        metrics = {}
        names = list(rs[0]["record"]["metrics"]) + ["control_MBps"]
        for m in names:
            def samples(r):
                rec = r["record"]
                return (rec["control_MBps"] if m == "control_MBps" else rec["metrics"][m])["samples"]

            side = {}
            for s in ("parent", "change"):
                mine = [r for r in rs if r["side"] == s]
                pooled = spread([x for r in mine for x in samples(r)])
                del pooled["samples"]
                side[s] = {**pooled,
                           "invocation_medians": [statistics.median(samples(r)) for r in mine]}
            pairs = [(rs[i], rs[i + 1]) for i in range(0, len(rs) - 1, 2)]
            wins = sum(
                statistics.median(samples(c)) > statistics.median(samples(p))
                for a, b in pairs
                for p, c in [(a, b) if a["side"] == "parent" else (b, a)]
            )
            metrics[m] = {**side, "pairs": len(pairs), "change_wins": wins,
                          "ratio": side["change"]["median"] / side["parent"]["median"]}
        router, traced = {}, {}
        for s in ("parent", "change"):
            reps = [rep for r in rs if r["side"] == s for rep in r["record"]["router"]]
            counts = {}
            for key in reps[0]:
                vals = [rep[key] for rep in reps]
                if all(isinstance(v, int) for v in vals):
                    counts[key] = {str(v): vals.count(v) for v in sorted(set(vals))}
                else:
                    counts[key] = {"median": statistics.median(vals)}
            router[s] = counts
            layers = [r["record"]["layers"] for r in rs if r["side"] == s]
            traced[s] = {**{k: _span([lay.get(k) for lay in layers]) for k in TRACED},
                         "host_s": {k: _span([lay["host_s"][k] for lay in layers])
                                    for k in layers[0]["host_s"]}}
        out[cell] = {"metrics": metrics, "router": router, "traced": traced}
    return out


def print_summary(summary: dict) -> None:
    for cell, s in summary.items():
        for m, v in s["metrics"].items():
            p, c = v["parent"], v["change"]
            print(f"{cell} {m}: parent median {p['median']:.3f} [{p['q1']:.3f}, {p['q3']:.3f}] "
                  f"n {p['n']}, change median {c['median']:.3f} [{c['q1']:.3f}, {c['q3']:.3f}] "
                  f"n {c['n']}; change/parent {v['ratio']:.4f}; change won {v['change_wins']} of "
                  f"{v['pairs']} pairs; invocation medians parent "
                  f"{[round(x, 3) for x in p['invocation_medians']]} change "
                  f"{[round(x, 3) for x in c['invocation_medians']]}", flush=True)
        for side in ("parent", "change"):
            print(f"{cell} router {side}: {json.dumps(s['router'][side])}", flush=True)
            print(f"{cell} traced {side}: {json.dumps(s['traced'][side])}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--cell", action="append", help="a workload of BENCHMARK.json (repeatable)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bench_turns.json")
    ap.add_argument("--summary", type=Path, nargs="+", help="print the summary of written --out files")
    args = ap.parse_args(argv)
    if args.summary is not None:
        print_summary(summarize(*(json.loads(f.read_text())["runs"] for f in args.summary)))
        return 0
    if args.parent is None or not args.cell:
        ap.error("--parent and --cell are needed")
    parent = args.parent.resolve()
    for f in ("bench_torch.py", "BENCHMARK.json"):
        if (parent / f).read_bytes() != (ROOT / f).read_bytes():
            print(f"bench_turns FAILED: {f} differs between {parent} and {ROOT}", file=sys.stderr)
            return 2
    card = smi()
    print(card, flush=True)
    work = args.out.parent / (args.out.stem + "_parts")
    work.mkdir(parents=True, exist_ok=True)
    runs: list = []
    for cell in args.cell:
        for rnd in range(args.rounds):
            for i, side in enumerate(ORDER):
                tree = parent if side == "parent" else ROOT
                part = (work / f"{cell}_{rnd}_{i}.json").resolve()
                part.unlink(missing_ok=True)
                proc = subprocess.run(
                    [sys.executable, str(tree / "bench_torch.py"), "--seed", str(args.seed),
                     "--cell", cell, "--out", str(part)],
                    cwd=str(tree), capture_output=True, text=True, timeout=1200)
                if proc.returncode:
                    print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr, flush=True)
                    print(f"bench_turns FAILED: {side} {cell} round {rnd} exited with "
                          f"{proc.returncode}", file=sys.stderr)
                    return 1
                (rec,) = json.loads(part.read_text())
                runs.append({"side": side, "round": rnd, "record": rec})
                print(f"{cell} round {rnd} {side}: cold_MBps median "
                      f"{rec['metrics']['cold_MBps']['median']:.3f}", flush=True)
                args.out.write_text(json.dumps(
                    {"card": card, "order": list(ORDER), "runs": runs}, indent=1))
    summary = summarize(runs)
    args.out.write_text(json.dumps(
        {"card": card, "order": list(ORDER), "runs": runs, "summary": summary}, indent=1))
    print_summary(summary)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
