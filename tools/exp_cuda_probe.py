#!/usr/bin/env python3
"""Runner of the pair-table probe experiment on an NVIDIA card.

The counterpart of ``tools/exp_pallas_dma.py`` (K3, K4) and
``tools/exp_pallas_bigtable.py`` (K5) for the PyTorch / CUDA port: a
``[S, 128]`` tile of pairs probes a full-vocabulary pair table through the
production probe (``tt_lookup_pairs``), the row-copy kernel (K3), the
L2-resident row kernel (K4) and the one-hot int8 tensor-core kernel (K5),
each held bit for bit to ``PairTable.lookup`` and timed with CUDA events
beside its plain PyTorch version.

Usage, from the repository root:

    python3 tools/exp_cuda_probe.py --table gpt2 [--tile 16]
    python3 tools/exp_cuda_probe.py --table cl100k_synth --device cpu   # plain versions only

Prints a header JSON line (table, shape, device, and on the card its name
and power limit), then one JSON line per arm.  Exits non-zero if an arm
is not bit-exact.  Without a card it refuses to run unless ``--device
cpu`` is given, and then it runs and checks only the plain versions and
times nothing.  It never imports jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", choices=("gpt2", "cl100k_synth"), default="gpt2")
    ap.add_argument("--tile", type=int, default=16, help="S of the [S, 128] probe tile")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "exp_cuda_probe: no CUDA card (torch.cuda.is_available() is False); "
            "pass --device cpu to check the plain versions only"
        )
    if args.tile < 1:
        raise SystemExit("--tile must be positive")

    from tokenizer_tpu.vocab import Vocabulary
    from tokenizer_tpu_torch.ops.exp_probe import run_arms

    table = Vocabulary.for_encoding(args.table, allow_fetch=False).pair_table()
    shape = (args.tile, 128)
    head = {
        "table": args.table,
        "table_slots": table.n_slots,
        "max_probes": table.max_probes,
        "probe_shape": list(shape),
        "device": str(device),
    }
    if device.type == "cuda":
        head["card"] = torch.cuda.get_device_name(device)
        head["name_power_limit"] = _card_line()
    print(json.dumps(head), flush=True)
    records = run_arms(table, device, shape)
    for rec in records:
        print(json.dumps(rec), flush=True)
    ok = all(r["plain_bit_exact"] and r.get("bit_exact", True) for r in records)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
