"""How the merge kernel's time scales with its tile, on one card.

For each packer bucket L, one tile of ``chip_smoke.py``'s phase 3 pieces
(the cl100k_synth table by default) is cut to B = 1,024 columns (128
blocks of the warp-per-column kernel: one block per SM, a single wave)
and to B = 8,192 (the packer's widest tile).  The kernel and the port's
first kernel are timed queued behind a sleep kernel, so that no host
enqueue is in the time (``exp_probe.queued_ms``).  The kernel is then
timed warm and cold by one method, CUDA events around each call, all
queued behind a sleep kernel: warm with nothing between the calls, cold
with 256 MB of other writes ahead of each call, which push the pair
table and the tile out of the 50 MB L2.  Their difference is what the
table's residency costs.  Beside the times: the merges of the tile, the
most merges in one column (the longest dependent chain of argmin,
relink and re-probe), and the device time per step of that chain.  If
the kernel is bound by that chain, the single-wave tile takes about as
long per step as the full one.

Usage, with one CUDA card visible, from the repository root:

  python3 tools/merge_kernel_scaling.py [--table cl100k_synth] [--seed 0] [--out FILE]

Prints one JSON line per (L, B) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WIDTHS = (1024, 8192)
FLUSH_BYTES = 256 << 20


def queued_each_ms(fn, before=None, reps: int = 5) -> float:
    """Median device ms of one ``fn()`` call: ``reps`` calls with CUDA
    events around each and ``before()``, if given, ahead of each, all
    queued behind a sleep kernel that outlasts their enqueue, so neither
    the host's enqueue nor ``before`` is in the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]

    def enqueue():
        for start, end in events:
            if before is not None:
                before()
            start.record()
            fn()
            end.record()

    t0 = time.perf_counter()
    enqueue()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # As exp_probe.queued_ms: twice the enqueue time at 2 GHz, plus 1 ms.
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * 2e9))
    enqueue()
    events[-1][1].synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", choices=("gpt2", "cl100k_synth"), default="cl100k_synth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("merge_kernel_scaling: torch.cuda.is_available() is False")
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(REPO / "build" / "tokenizer_tpu_cache"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.ops.exp_probe import queued_ms
    from tokenizer_tpu_torch.ops.merge_torch import device_table

    device = torch.device("cuda", 0)
    card = cs.smi_line()
    tok = tt.create_by_encoder_name(args.table, allow_fetch=False, device=device)
    table = tok.table
    tab = device_table(table, device)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    seed_text = (REPO / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    rng = np.random.default_rng(args.seed)
    sample = cs.gen_corpus(1.0, args.seed + 1, seed_text)
    pieces = cs.bucket_pieces(tok, sample, rng, max(WIDTHS))
    junk = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    records = []
    for L in cs.BUCKETS:
        for B in WIDTHS:
            ids, lengths = cs.pack(table, pieces[L][:B], L)
            di, dl = torch.from_numpy(ids).to(device), torch.from_numpy(lengths).to(device)
            k_ids, k_n = merge_cuda.merge_packed(tab, di, dl, **kw)
            v_ids, v_n = merge_cuda.merge_packed_v1(tab, di, dl, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(k_ids, v_ids) and torch.equal(k_n, v_n)):
                raise SystemExit(f"merge_kernel_scaling: kernels differ at [{L}, {B}]")
            new = partial(merge_cuda.merge_packed, tab, di, dl, **kw)
            ms = queued_ms(new)
            merges = lengths.astype(np.int64) - k_n.cpu().numpy()
            rec = {
                "table": args.table, "L": L, "B": B, "ms": ms,
                "v1_ms": queued_ms(partial(merge_cuda.merge_packed_v1, tab, di, dl, **kw)),
                "warm_ms": queued_each_ms(new), "cold_ms": queued_each_ms(new, junk.zero_),
                "merges": int(merges.sum()),
                "max_merges_per_column": int(merges.max()),
                "mean_merges_per_column": float(merges.mean()),
                "device_us_per_chain_step": ms * 1e3 / max(int(merges.max()), 1),
            }
            records.append(rec)
            print(json.dumps(rec), flush=True)
    print(card, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
