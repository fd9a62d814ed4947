#!/usr/bin/env python3
"""K5, the one-hot int8 probe, on the card: device time per table against
its operations bound and against ``torch._int_mm`` on the same product.

    python3 tools/onehot_ab.py [--tables gpt2,cl100k_synth,o200k_synth] [--reps 10]
    python3 tools/onehot_ab.py --parent DIR [--out FILE]

The first form measures this tree.  The second runs the same measurement
in four processes, in turns: the tree at DIR (say ``git archive`` of the
parent commit, unpacked under ``build/``), this tree, this tree, DIR; it
prints every record and writes them, with the card's name and power
limit, to ``--out``.  ``--root DIR`` (used by the turns) imports
``tokenizer_tpu_torch`` from DIR.

Per table, on a ``[16, 128]`` tile of ``exp_probe.make_probes`` pairs:

* ``wrapper_us``: ``probe_cuda.lookup_onehot`` as a caller makes it, with
  the table laid out as that tree's ``exp_probe.arm_calls`` lays it out;
* ``kernel_us``: the library's ``tt_lookup_onehot`` alone, operands and
  scratch made beforehand;
* ``int_mm_us``: ``torch._int_mm(onehot, B)``, the same ``[M, K] x [K, N]``
  int8 product (M = S * 128 * max_probes, K = n_rows, N = 1,536) from
  ``exp_probe.onehot_product``: the one-hot matrix made beforehand, B the
  K-major table viewed as ``[K, N]``; checked against the rows of B it
  must select.  Only in a tree that has ``onehot_product``;
* the operations bound ``2 M K N`` over 1,979 TOP/s (H100 SXM dense int8),
  the share of it each time reaches, and the bytes of B that shared memory
  receives per call (``l2_to_smem_bytes``) for that tree's tiling.

Times are device times, ``exp_probe.queued_ms``: calls queued behind a
sleep kernel, CUDA events.  Every call is checked bit for bit against
``PairTable.lookup``.  Needs a card; imports nothing of jax.
"""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial
from pathlib import Path

import ab_turns

ROOT = ab_turns.ROOT
TABLES = ("gpt2", "cl100k_synth", "o200k_synth")
SHAPE = (16, 128)
#: NVIDIA H100 SXM dense int8 tensor-core peak, operations/s (data sheet).
INT8_OPS_PER_S = 1979e12
N_COLS = 4 * 3 * 128


def ptxas_lines(report: str) -> dict:
    """ptxas -v lines of each onehot entry function, and ptxas's wgmma
    and setmaxnreg advisories."""
    by_fn = ab_turns.ptxas_lines(report, lambda fn: "onehot" in fn)
    advisories = [l.strip() for l in report.splitlines() if "wgmma" in l or "setmaxnreg" in l]
    if advisories:
        by_fn["advisories"] = advisories
    return by_fn


def worker(root: Path, tables, reps: int) -> None:
    import numpy as np
    import torch

    from tokenizer_tpu_torch.ops import exp_probe, probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe_torch import bigtable_device_table
    from tokenizer_tpu_torch.runtime import build
    from tokenizer_tpu_torch.vocab import Vocabulary

    if not torch.cuda.is_available():
        raise SystemExit("onehot_ab: needs a CUDA card")
    device = torch.device("cuda", 0)
    new = hasattr(probe_cuda, "onehot_tiling")
    _, report = build.build_library()
    lib = build.load_library()
    print(json.dumps({"tree": str(root), "new_kernel": new,
                      "ptxas": ptxas_lines(report)}), flush=True)
    for name in tables:
        table = Vocabulary.for_encoding(name, allow_fetch=False).pair_table()
        sb, mp = table.slot_bits, table.max_probes
        l_np, r_np = exp_probe.make_probes(table, SHAPE)
        want = table.lookup(l_np, r_np)
        left = torch.from_numpy(l_np).to(device)
        right = torch.from_numpy(r_np).to(device)
        S, n_pairs = SHAPE[0], SHAPE[0] * SHAPE[1]
        tab8 = bigtable_device_table(table, device)
        n_rows = tab8.shape[1]
        tab_k = tab8.transpose(1, 2).contiguous()  # [4, 384, n_rows], the K-major bytes
        m_rows, stream = n_pairs * mp, torch.cuda.current_stream(device).cuda_stream
        out = torch.empty_like(left)
        scratch = torch.empty((3, mp, n_pairs), dtype=torch.int32, device=device)
        if new:
            from tokenizer_tpu_torch.ops.exp_probe_torch import bigtable_kmajor

            call_tab = bigtable_kmajor(tab8)
            tiling = probe_cuda.onehot_tiling(S, mp, n_rows)
            grid = tiling.grid(torch.cuda.get_device_properties(device).multi_processor_count)
            extra = (tiling.m_tiles, grid)
            l2_bytes = tiling.l2_to_smem_bytes
        else:
            call_tab, extra = tab8, ()
            l2_bytes = S * mp * 4 * 3 * 128 * n_rows  # a block per (row of 128, round, plane)

        def wrapper():
            return probe_cuda.lookup_onehot(call_tab, left, right, slot_bits=sb, max_probes=mp)

        def kernel():
            rc = lib.tt_lookup_onehot(tab_k.data_ptr(), n_rows, sb, mp, left.data_ptr(),
                                      right.data_ptr(), out.data_ptr(), scratch.data_ptr(), S,
                                      *extra, stream)
            if rc:
                raise RuntimeError(f"tt_lookup_onehot: {lib.tt_error_string(rc).decode()} ({rc})")
            return out

        exact = {}
        for what, fn in (("wrapper", wrapper), ("kernel", kernel)):
            got = fn()
            torch.cuda.synchronize()
            exact[what] = bool(np.array_equal(got.cpu().numpy(), want))
        wrapper_ms = exp_probe.queued_ms(wrapper, reps)
        kernel_ms = exp_probe.queued_ms(kernel, reps)

        # The library's int8 GEMM on the same product, as a yardstick (the
        # trees with exp_probe.onehot_product only).
        lib_rec = {}
        if hasattr(exp_probe, "onehot_product"):
            a, b, target = exp_probe.onehot_product(call_tab, left, right, slot_bits=sb,
                                                    max_probes=mp)
            got = torch._int_mm(a, b)
            int_mm_ms = exp_probe.queued_ms(lambda: torch._int_mm(a, b), reps)
            lib_rec = {"int_mm_us": int_mm_ms * 1e3,
                       "int_mm_exact": bool(torch.equal(got, b[target].to(torch.int32))),
                       "kernel_over_int_mm": kernel_ms / int_mm_ms}
            del a, got

        ops = 2 * m_rows * n_rows * N_COLS
        bound_us = ops / INT8_OPS_PER_S * 1e6
        print(json.dumps({
            "tree": str(root), "new_kernel": new, "table": name, "shape": list(SHAPE),
            "M": m_rows, "K": n_rows, "N": N_COLS, "ops": ops, "ops_bound_us": bound_us,
            "wrapper_us": wrapper_ms * 1e3, "kernel_us": kernel_ms * 1e3,
            "kernel_share_of_bound": bound_us / (kernel_ms * 1e3),
            "l2_to_smem_bytes": l2_bytes, "table_bytes": N_COLS * n_rows,
            "bit_exact": exact, "reps": reps, **lib_rec,
        }), flush=True)
        if not (all(exact.values()) and lib_rec.get("int_mm_exact", True)):
            raise SystemExit(f"onehot_ab: {name} not exact: {exact}, {lib_rec}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", default=",".join(TABLES))
    ap.add_argument("--reps", type=int, default=10)
    ab_turns.add_arguments(ap, ROOT / "build" / "onehot_ab.json")
    args = ap.parse_args(argv)
    tables = [t for t in args.tables.split(",") if t]
    return ab_turns.run(args, __file__, ["--tables", ",".join(tables), "--reps", str(args.reps)],
                        partial(worker, tables=tables, reps=args.reps))


if __name__ == "__main__":
    sys.exit(main())
