"""Old against new on one card, in turns: the runner the A/B tools share.

A tool (``tools/onehot_ab.py``, ``tools/rows_ab.py``) measures one tree in
its ``worker`` and prints one JSON line per record.  With ``--parent DIR``
it runs that worker in four processes, in turns: the tree at DIR (say
``git archive`` of the parent commit, unpacked under ``build/``), this
tree, this tree, DIR; it prints every line and writes the records, with
the card's name and power limit, to ``--out``.  ``--root DIR`` (used by
the turns) imports ``tokenizer_tpu_torch`` from DIR.  The worker is always
this tree's tool, so both trees are measured by the same code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, List

ROOT = Path(__file__).resolve().parent.parent
ORDER = ("parent", "change", "change", "parent")


def smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def add_arguments(ap: argparse.ArgumentParser, out: Path) -> None:
    ap.add_argument("--root", type=Path, default=None, help="import tokenizer_tpu_torch from here")
    ap.add_argument("--parent", type=Path, default=None, help="run in turns against this tree")
    ap.add_argument("--out", type=Path, default=out)


def turns(script: str, parent: Path, worker_args: List[str], out: Path) -> int:
    """Run ``script --root R *worker_args`` for R in parent, this tree,
    this tree, parent; collect the JSON lines into ``out``."""
    card = smi()
    print(card, flush=True)
    env = dict(os.environ)
    env.setdefault("TOKENIZER_TPU_CACHE_DIR", str(ROOT / "build" / "ab_cache"))
    records = []
    for root in (parent, ROOT, ROOT, parent):
        run = subprocess.run([sys.executable, script, "--root", str(root), *worker_args],
                             capture_output=True, text=True, timeout=1200, env=env, cwd=str(root))
        for line in run.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                records.append(json.loads(line))
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
            return run.returncode
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "order": list(ORDER), "records": records}, indent=1))
    print(card, flush=True)
    return 0


def run(args: argparse.Namespace, script: str, worker_args: List[str],
        worker: Callable[[Path], None]) -> int:
    """The tool's ``main``: the turns with ``--parent``, else ``worker``
    on the tree at ``--root`` (this one by default)."""
    if args.parent is not None:
        return turns(script, args.parent.resolve(), worker_args, args.out)
    root = (args.root or ROOT).resolve()
    sys.path.insert(0, str(root))
    worker(root)
    return 0


def ptxas_lines(report: str, keep: Callable[[str], bool]) -> dict:
    """``ptxas -v`` lines of the entry functions ``keep`` accepts, by
    mangled name."""
    by_fn, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif fn and keep(fn) and ("Used " in line or "spill" in line):
            by_fn.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return by_fn
