"""Folder throughput benchmark — the port's copy of
:mod:`tokenizer_tpu.runtime.perf`.

Mirrors `tokenizer_ts/perf/benchmark-folder.js:1-65`: recursively read a
corpus folder's source files (.ts/.js/.py + common code/text types),
loop encode for >= min_seconds and >= min_cycles, report
``{"totalSize": bytes, "cycles": [seconds, ...]}`` plus derived MB/s —
the same JSON contract the reference's notebook consumes
(`perf/notebook.ipynb` run_benchmark).  It runs on the card by default
(``device="cuda"``, bulk ``encode_batch``); ``device=None`` measures the
host engine's per-document ``encode``.  ``profile_dir`` wraps one cycle
in :func:`tokenizer_tpu_torch.runtime.profiler.trace`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional

__all__ = ["read_folder_corpus", "run_folder_benchmark"]

#: benchmark-folder.js:12 reads .ts/.js/.py; we accept a few more.
_EXTS = {".ts", ".js", ".py", ".rs", ".txt", ".md", ".json", ".c", ".cc",
         ".cpp", ".h", ".java", ".go"}


def read_folder_corpus(folder: str, max_bytes: Optional[int] = None) -> List[str]:
    docs: List[str] = []
    total = 0
    for p in sorted(Path(folder).rglob("*")):
        if not (p.is_file() and p.suffix in _EXTS):
            continue
        try:
            text = p.read_text(encoding="utf-8", errors="replace")
        except OSError:
            continue
        docs.append(text)
        total += len(text.encode("utf-8"))
        if max_bytes and total >= max_bytes:
            break
    return docs


def run_folder_benchmark(
    folder: str,
    model: str = "gpt2",
    min_seconds: float = 10.0,
    min_cycles: int = 5,
    device="cuda",
    trim_suffix_budget: Optional[int] = None,
    profile_dir: Optional[str] = None,
) -> dict:
    """Loop-encode a folder corpus; returns the TS harness's JSON shape.

    ``trim_suffix_budget`` switches the measured op to encodeTrimSuffix
    like the reference harness's second mode (benchmark-folder.js:30-35).
    A ``device`` of ``"cuda"`` without a card raises.
    """
    from ..builder import create_by_encoder_name, create_by_model_name

    try:
        tokenizer = create_by_model_name(model, device=device)
    except ValueError:  # encoder names work too (cl100k_synth, gpt2)
        tokenizer = create_by_encoder_name(model, device=device)
    docs = read_folder_corpus(folder)
    total_size = sum(len(d.encode("utf-8")) for d in docs)
    if total_size == 0:
        raise ValueError(f"no corpus files under {folder!r}")

    def one_cycle() -> int:
        n = 0
        if device is not None and trim_suffix_budget is None:
            for ids in tokenizer.encode_batch(docs):
                n += len(ids)
        else:
            for d in docs:
                if trim_suffix_budget is not None:
                    ids = tokenizer.encode_trim_suffix(
                        d, trim_suffix_budget
                    ).token_ids
                else:
                    ids = tokenizer.encode(d)
                n += len(ids)
        return n

    one_cycle()  # warm-up: kernel build + dedup/cache population

    cycles: List[float] = []
    tokens = 0
    profiled = False
    t_start = time.perf_counter()
    while len(cycles) < min_cycles or time.perf_counter() - t_start < min_seconds:
        if profile_dir and not profiled:
            from .profiler import trace

            profiled = True
            with trace(profile_dir):
                t0 = time.perf_counter()
                tokens = one_cycle()
                cycles.append(time.perf_counter() - t0)
            continue
        t0 = time.perf_counter()
        tokens = one_cycle()
        cycles.append(time.perf_counter() - t0)

    best = min(cycles)
    return {
        "totalSize": total_size,
        # Small corpora can accumulate thousands of cycles in
        # min_seconds; keep the report bounded.
        "cycles": cycles if len(cycles) <= 50 else cycles[:50],
        "n_cycles": len(cycles),
        "tokens": tokens,
        "files": len(docs),
        "mb_per_s_best": round(total_size / best / 1e6, 3),
        "mb_per_s_mean": round(
            total_size * len(cycles) / sum(cycles) / 1e6, 3
        ),
    }
