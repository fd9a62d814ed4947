#!/usr/bin/env python3
"""K3 and K4, the row-copy and resident-row probes, on the card: device
time per table and tile beside the byte bound and K1's probe.

    python3 tools/rows_ab.py [--tables gpt2,cl100k_synth,o200k_synth] [--reps 10]
    python3 tools/rows_ab.py --parent DIR [--out FILE]

The first form measures this tree; the second runs it in four processes,
in turns, against the tree at DIR (``tools/ab_turns.py``: DIR, this tree,
this tree, DIR), for instance ``git archive`` of the parent commit
unpacked under ``build/``.

Per table, on a ``[16, 128]`` and a ``[1024, 128]`` tile of
``exp_probe.make_probes`` pairs, three probes, each twice:

* ``kernel``: the library's function alone (``tt_lookup_pairs``, K1's
  probe; ``tt_probe_rows_async``, K3; ``tt_probe_rows_resident``, K4),
  operands made beforehand;
* ``wrapper``: ``merge_cuda.lookup_pairs``, ``probe_cuda.probe_rows_async``
  and ``probe_cuda.probe_rows_resident`` as a caller makes them.

K4 runs inside ``probe_cuda.persisting_l2`` sized to its planes.  Beside
the times: the tile's byte bound (``chip_smoke.probe_bound_us``: pairs in,
ids out, the table slots its distinct valid pairs read, each once, over
3.35 TB/s), and the bytes the tree's K3 moves from L2: the windows of
``probe_cuda.probe_windows`` in a tree that has it, else three 512-byte
rows a round for every pair.  The first line of each process gives
``ptxas -v``'s lines for both kernels of ``csrc/probe_rows.cu``.

Times are device times, ``exp_probe.queued_ms``: calls queued behind a
sleep kernel, CUDA events.  Every call is checked bit for bit against
``PairTable.lookup``.  Needs a card; imports nothing of jax.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from functools import partial
from pathlib import Path

import ab_turns

ROOT = ab_turns.ROOT
TABLES = ("gpt2", "cl100k_synth", "o200k_synth")
SHAPES = ((16, 128), (1024, 128))
ROW_BYTES = 3 * 128 * 4  # a row of each plane, what the first K3 copied a round


def _chip_smoke():
    """This tree's chip_smoke.py, for its byte bound."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: Path, tables, reps: int) -> None:
    import numpy as np
    import torch

    from tokenizer_tpu_torch.ops import exp_probe, merge_cuda, probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe_torch import table_planes_2d
    from tokenizer_tpu_torch.ops.merge_torch import device_table
    from tokenizer_tpu_torch.runtime import build
    from tokenizer_tpu_torch.vocab import Vocabulary

    if not torch.cuda.is_available():
        raise SystemExit("rows_ab: needs a CUDA card")
    device = torch.device("cuda", 0)
    new = hasattr(probe_cuda, "probe_windows")
    smoke = _chip_smoke()
    _, report = build.build_library()
    lib = build.load_library()
    print(json.dumps({"tree": str(root), "new_kernel": new, "ptxas": ab_turns.ptxas_lines(
        report, lambda fn: "probe_rows" in fn)}), flush=True)
    stream = torch.cuda.current_stream(device).cuda_stream
    for name in tables:
        table = Vocabulary.for_encoding(name, allow_fetch=False).pair_table()
        kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
        planes = table_planes_2d(table, device)
        tab = device_table(table, device)
        lo = min(p.data_ptr() for p in planes)
        window = (lo, max(p.data_ptr() + p.numel() * 4 for p in planes) - lo)
        for shape in SHAPES:
            l_np, r_np = exp_probe.make_probes(table, shape)
            want = table.lookup(l_np, r_np)
            left = torch.from_numpy(l_np).to(device)
            right = torch.from_numpy(r_np).to(device)
            out = torch.empty_like(left)
            n = left.numel()
            pairs = (left.data_ptr(), right.data_ptr(), out.data_ptr(), n)

            def alone(fn, *table_ptrs, extra=()):
                def call():
                    rc = fn(*table_ptrs, table.slot_bits, table.max_probes, *pairs, *extra, stream)
                    if rc:
                        raise RuntimeError(f"{fn.__name__}: {lib.tt_error_string(rc).decode()}")
                    return out
                return call

            calls = {
                "lookup_pairs": (
                    alone(lib.tt_lookup_pairs, *merge_cuda._tab_ptrs(tab)),
                    lambda: merge_cuda.lookup_pairs(tab, left.reshape(-1), right.reshape(-1), **kw),
                ),
                "probe_rows_async": (
                    alone(lib.tt_probe_rows_async, *(p.data_ptr() for p in planes)),
                    lambda: probe_cuda.probe_rows_async(planes, left, right, **kw),
                ),
                "probe_rows_resident": (
                    alone(lib.tt_probe_rows_resident, *(p.data_ptr() for p in planes),
                          extra=window),
                    lambda: probe_cuda.probe_rows_resident(planes, left, right, **kw),
                ),
            }
            us, exact = {}, {}
            for arm, (kernel, wrapper) in calls.items():
                with exp_probe.l2_for(arm, table, device):
                    for what, fn in (("kernel", kernel), ("wrapper", wrapper)):
                        got = fn().reshape(shape)
                        torch.cuda.synchronize()
                        exact[f"{arm}/{what}"] = bool(np.array_equal(got.cpu().numpy(), want))
                        us[f"{arm}/{what}"] = exp_probe.queued_ms(fn, reps) * 1e3
            bound = smoke.probe_bound_us(table, shape)
            if new:
                homes = probe_cuda.pair_homes(l_np, r_np, table.slot_bits)
                moved = {"window_bytes": probe_cuda.probe_windows(
                    homes, table.max_probes, table.slot_bits).bytes}
            else:
                moved = {"row_bytes": n * table.max_probes * ROW_BYTES}
            print(json.dumps({
                "tree": str(root), "new_kernel": new, "table": name, "shape": list(shape),
                "pairs": n, "max_probes": table.max_probes, "bound_us": bound, **moved,
                "us": us, "share_of_bound": {k: bound / v for k, v in us.items()},
                "over_lookup_pairs": {k: v / us["lookup_pairs/kernel"] for k, v in us.items()},
                "bit_exact": exact, "reps": reps,
            }), flush=True)
            if not all(exact.values()):
                raise SystemExit(f"rows_ab: {name} {shape} not exact: {exact}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", default=",".join(TABLES))
    ap.add_argument("--reps", type=int, default=10)
    ab_turns.add_arguments(ap, ROOT / "build" / "rows_ab.json")
    args = ap.parse_args(argv)
    tables = [t for t in args.tables.split(",") if t]
    return ab_turns.run(args, __file__, ["--tables", ",".join(tables), "--reps", str(args.reps)],
                        partial(worker, tables=tables, reps=args.reps))


if __name__ == "__main__":
    sys.exit(main())
