"""The port's cold stream over mesh layouts, and card placement under torchrun.

1. Layouts (default).  The ~8 MB cl100k_synth corpus of chip_smoke.py
   (``--seed``) streams in 256-document chunks through fresh tokenizers
   with every wave on the card, in turns each round: ``1 card`` (one
   device), ``2 shards of cuda:0`` (a mesh of one card: two streams,
   uploads and launches per wave) and, with more than one card, ``N
   cards`` (a mesh of every card).  Every run must equal a host-routed
   reference document for document.  Per layout: MB/s of each round and
   their median, device waves, uploads a wave, device_blocking_s and the
   merge kernel's launches by device (``merge_cuda.STREAM_LAUNCHES``).
2. Placement (``--placement``), one process per rank under torchrun: the
   cards the rank owns (``parallel.mesh.local_devices``), the device and
   mesh ``GpuTokenizer`` resolves, whether a forced gpt2 encode of
   lib.rs.txt gives the golden ids, and the devices its launches went to.

Usage, from the repository root, with CUDA cards visible:

  python3 tools/mesh_scaling.py [--seed 0] [--rounds 4] [--out FILE]
  torchrun --standalone --nproc-per-node N tools/mesh_scaling.py --placement

``--out`` also writes the layouts' record as JSON.  jax is never imported.
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


def placement() -> dict:
    """This rank's cards, resolved device and mesh, and a golden check."""
    import torch

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.parallel import local_devices

    tok = tt.create_by_encoder_name("gpt2", allow_fetch=False)
    tok._host_pp = float("inf")  # every wave to the card
    tok._host_wave_max = 0
    text = (REPO / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    (ids,) = tok.encode_batch([text])
    torch.cuda.synchronize()
    golden = json.loads((REPO / "tests" / "testdata" / "tokens_gpt2.json").read_text())
    return {
        "rank": os.environ.get("RANK"),
        "local_rank": os.environ.get("LOCAL_RANK"),
        "local_devices": [str(d) for d in local_devices()],
        "device": str(tok.device),
        "mesh": [str(d) for d in tok.mesh.devices] if tok.mesh is not None else None,
        "golden": list(ids) == golden,
        "launch_devices": sorted({d for d, _ in merge_cuda.STREAM_LAUNCHES}),
    }


def layouts(seed: int, rounds: int) -> dict:
    import numpy as np
    import torch

    import tokenizer_tpu_torch as tt
    from chip_smoke import CHUNK_DOCS, CORPUS_MB, gen_corpus, host_reference
    from tokenizer_tpu_torch.ops import merge_cuda
    from tokenizer_tpu_torch.parallel import data_mesh, local_devices

    seed_text = (REPO / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    docs = gen_corpus(CORPUS_MB, seed, seed_text)
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    want = host_reference("cl100k_synth").encode_batch(docs)
    chunks = [docs[i : i + CHUNK_DOCS] for i in range(0, len(docs), CHUNK_DOCS)]
    local = local_devices()
    shapes = {"1 card": None, "2 shards of cuda:0": [local[0]] * 2}
    if len(local) > 1:
        shapes[f"{len(local)} cards"] = local
    rec = {name: {"MBps": []} for name in shapes}
    for r in range(rounds):
        for name in list(shapes) if r % 2 == 0 else list(shapes)[::-1]:
            mesh = data_mesh(devices=shapes[name]) if shapes[name] else None
            tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, mesh=mesh)
            tok._host_pp = float("inf")  # every wave to the card(s)
            tok._host_wave_max = 0
            tok._ensure_device()  # the tables' uploads outside the timed region
            torch.cuda.synchronize()
            merge_cuda.STREAM_LAUNCHES.clear()
            t0 = time.perf_counter()
            out = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            if len(out) != len(want) or not all(map(np.array_equal, out, want)):
                raise SystemExit(f"mesh_scaling: {name} differs from the host reference")
            st = tok.stats
            by_device = {}
            for (dev, _), n in merge_cuda.STREAM_LAUNCHES.items():
                by_device[dev] = by_device.get(dev, 0) + n
            rec[name]["MBps"].append(nbytes / s / 1e6)
            rec[name].update(
                device_waves=st.device_waves,
                uploads_per_wave=st.device_uploads / max(st.device_waves, 1),
                device_blocking_s=st.device_blocking_s,
                streams=len(merge_cuda.STREAM_LAUNCHES),
                launches_by_device=by_device,
            )
    for r in rec.values():
        r["median_MBps"] = statistics.median(r["MBps"])
    return {"bytes": nbytes, "docs": len(docs), "rounds": rounds, "layouts": rec}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--placement", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_scaling: torch.cuda.is_available() is False")
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(REPO / "build" / "tokenizer_tpu_cache"))
    sys.path.insert(0, str(REPO))
    if args.placement:
        print("PLACEMENT " + json.dumps(placement()), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    rec = {"cards": smi, **layouts(args.seed, args.rounds)}
    for name, r in rec["layouts"].items():
        print(f"{name}: {json.dumps(r)}", flush=True)
    print(f"cards: {smi}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
