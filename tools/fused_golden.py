#!/usr/bin/env python3
"""The fused scan calls on a fixed input: what they return and what they count.

    python3 tools/fused_golden.py [--root DIR] [--out FILE]

On a fresh ``SplitContext`` of cl100k_synth, one thread, the documents of
:func:`docs` (``tests/testdata/lib.rs.txt`` in documents of 20 lines, a
run of 700 CJK ideographs and runs of 150-600 letters) go through
``split_merge_batch`` and ``split_emit_batch``, each with rows for every
first-seen piece and with 500 rows, so that the tail defers.  Each call's
record: the scanner's counts (every ``SCAN_COUNTERS`` slot that is not a
time), ``n_fused``, the row high-water mark and a SHA-256 of its ids,
news, patches and the rows it wrote.  ``--root DIR`` imports
``tokenizer_tpu_torch`` from another tree of the repository (say ``git
archive`` of an earlier commit under ``build/``), so that an earlier
scanner's record can be written and a later one held to it
(``tests/test_torch_router.py``; ``tests/fused_abi13.json`` is
ABI 13's).  It prints the record and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the row matrix's rows in the tight case.
TIGHT_ROWS = 500


def docs() -> list:
    lines = (ROOT / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8").splitlines(True)
    out = ["".join(lines[i : i + 20]) for i in range(0, len(lines), 20)]
    out.append("前 " + "".join(chr(0x4E00 + (i * 37) % 2000) for i in range(700)) + " 后")
    out.append(" ".join("".join(chr(97 + (i * j) % 26) for i in range(150 * j)) for j in (1, 2, 4)))
    return out


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def record(native, table, pattern_id: int, **extra) -> dict:
    """Each fused call's record (see the module docstring); ``extra`` goes
    to every call (``defer_len=0`` on a scanner that takes it)."""
    import numpy as np

    datas = [d.encode("utf-8") for d in docs()]
    buf = b"".join(datas)
    lens = np.array([len(d) for d in datas], dtype=np.int64)
    ends = np.cumsum(lens)
    starts = ends - lens
    out = {}
    for call in ("split_merge_batch", "split_emit_batch"):
        for cap in ("ample", "tight"):
            ctx = native.SplitContext(pattern_id)
            rows_n = len(buf) if cap == "ample" else TIGHT_ROWS
            rows = np.zeros((rows_n, 128), np.int32)
            row_len = np.zeros(rows_n, np.int32)
            row_u16 = np.zeros(rows_n, np.int32)
            uid_rows = np.full(len(buf), -1, np.int32)
            uid_ids = np.zeros((len(buf), 8), np.int32)
            c = native.scan_counters()
            res = getattr(ctx, call)(buf, starts, ends, table, rows, row_len, row_u16, uid_rows, 0,
                                     nthreads=1, uid_ids=uid_ids, counters=c, **extra)
            if call == "split_merge_batch":
                buf_ids, offs, counts, news, n_rows, n_fused, _ = res
                patches = ()
            else:
                buf_ids, offs, counts, _, news, n_rows, n_fused, _, patches = res
                buf_ids = buf_ids.copy()
                for seg, pos, res_n in zip(patches[0], patches[1], patches[3]):
                    buf_ids[offs[seg] + pos : offs[seg] + pos + res_n] = -1  # a hole's slots
            # Each document's uids (or ids) only: the buffer's other slots
            # are not written.
            ids = np.concatenate([buf_ids[o : o + n] for o, n in zip(offs, counts)])
            counts = {k: v for k, v in native.scan_report(c).items() if not k.endswith("_s")}
            out[f"{call}/{cap}"] = {
                "counts": counts,
                "n_fused": n_fused,
                "n_rows": n_rows,
                "news": len(news[0]),
                "patches": len(patches[0]) if patches else 0,
                "sha256": _digest(ids, *news, *patches, rows[:n_rows], row_len[:n_rows],
                                  row_u16[:n_rows], uid_rows, uid_ids),
            }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "fused_golden.json")
    args = ap.parse_args(argv)
    os.environ.setdefault("TOKENIZER_TPU_CACHE_DIR", str(args.root / "build" / "tokenizer_tpu_cache"))
    sys.path.insert(0, str(args.root))
    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.runtime import native

    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu", mesh=None)
    takes = inspect.signature(native.SplitContext.split_emit_batch).parameters
    extra = {"defer_len": 0} if "defer_len" in takes else {}
    rec = {"abi": native.ABI_VERSION, "calls": record(native, tok.table, tok._native_pid, **extra)}
    print(json.dumps(rec, indent=1))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
