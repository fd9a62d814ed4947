"""The port's torch.distributed plumbing: two real gloo ranks on the CPU.

Two OS processes start the way torchrun starts them (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` in the environment) and call
``multihost.initialize()`` with no arguments.  Each contributes a
different counter vector to ``all_sum``; in the encode test each runs
``encode_corpus`` without shard arguments, so it takes its shard from
the job, and the union of the two shards' files must equal a
single-process run, document for document.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import require_vocab

from tokenizer_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parent.parent

DOCS = [f"doc {i}: the quick brown fox {i * 13} jumps ⭐ {'好' * (i % 7)}" for i in range(40)]

_WORKER = r"""
import json, sys
sys.path.insert(0, "@REPO@")
import torch.distributed as dist
from tokenizer_tpu_torch.parallel import multihost

multihost.initialize()
rank, world = multihost.process_info()
out = multihost.all_sum([10.0 * (rank + 1), 3.0 + rank])
rec = {"rank": rank, "world": world, "sum": [float(x) for x in out],
       "backend": str(dist.get_backend())}
if len(sys.argv) > 1:
    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.runtime.pipeline import encode_corpus

    docs = @DOCS@
    tok = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu")
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    p = encode_corpus(iter(docs), tok, sys.argv[1], chunk_bytes=400)
    totals = multihost.all_sum([p.docs, p.bytes_in, p.tokens_out])
    rec.update(shard=p.shard, n_shards=p.n_shards, docs=p.docs,
               device_pieces=tok.stats.device_pieces,
               totals=[float(x) for x in totals])
print("RESULT " + json.dumps(rec), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(extra_args, timeout: float, attempts: int = 2):
    """Launch the 2-rank job, returning ({rank: RESULT dict}, extra args).

    The free-port probe is TOCTOU (the store rebinds it after we close),
    and the rendezvous can miss its barrier when the host is briefly
    oversubscribed mid-suite, so one retry with a fresh port before
    declaring failure.  Every subprocess is waited on with a timeout and
    killed in ``finally``.
    """
    worker = _WORKER.replace("@REPO@", str(REPO)).replace("@DOCS@", repr(DOCS))
    last_err = ""
    for attempt in range(attempts):
        extra = extra_args(attempt) if callable(extra_args) else extra_args
        port = _free_port()
        procs = []
        for rank in (0, 1):
            env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "LOCAL_RANK")}
            env |= {
                "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port),
                "WORLD_SIZE": "2",
                "RANK": str(rank),
                "GLOO_SOCKET_IFNAME": "lo",
                "CUDA_VISIBLE_DEVICES": "",
            }
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-c", worker, *extra],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    text=True,
                    env=env,
                    cwd=str(REPO),
                )
            )
        results, ok = {}, True
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    ok = False
                    last_err = err[-2000:]
                    continue
                for line in out.splitlines():
                    if line.startswith("RESULT "):
                        rec = json.loads(line[len("RESULT ") :])
                        results[rec["rank"]] = rec
        except subprocess.TimeoutExpired:
            ok, last_err = False, "worker pair timed out"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if ok and set(results) == {0, 1}:
            return results, extra
    raise AssertionError(f"worker pair failed twice; last stderr:\n{last_err}")


def test_two_rank_all_sum_and_process_info():
    results, _ = _run_pair([], timeout=120)
    assert {r: (rec["rank"], rec["world"]) for r, rec in results.items()} == {0: (0, 2), 1: (1, 2)}
    # 10*(0+1)+10*(1+1)=30 ; (3+0)+(3+1)=7 — the same on both ranks.
    assert results[0]["sum"] == results[1]["sum"] == [30.0, 7.0]
    assert results[0]["backend"] == "gloo"


def test_two_rank_encode_corpus_takes_its_shard_from_the_job(tmp_path):
    require_vocab("gpt2")
    results, (out_dir,) = _run_pair(lambda a: [str(tmp_path / f"try{a}")], timeout=240)
    out_dir = Path(out_dir)
    assert {r: (rec["shard"], rec["n_shards"]) for r, rec in results.items()} == {
        0: (0, 2),
        1: (1, 2),
    }
    assert results[0]["docs"] + results[1]["docs"] == len(DOCS)
    assert all(rec["device_pieces"] > 0 for rec in results.values())

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.runtime.pipeline import encode_corpus

    tok = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu")
    single = encode_corpus(iter(DOCS), tok, tmp_path / "single", chunk_bytes=400)
    assert (single.shard, single.n_shards) == (0, 1)
    # The counter sums, on both ranks, are the single-process counters.
    want_totals = [float(single.docs), float(single.bytes_in), float(single.tokens_out)]
    assert results[0]["totals"] == results[1]["totals"] == want_totals

    def per_doc(directory: Path, shard: int) -> list:
        docs = []
        for f in sorted(directory.glob(f"tokens_s{shard:05d}_c*.npz")):
            z = np.load(f)
            ids, offs = z["ids"], z["offsets"]
            docs += [ids[offs[k] : offs[k + 1]].tolist() for k in range(len(offs) - 1)]
        return docs

    want = per_doc(tmp_path / "single", 0)
    union = {}
    for shard in (0, 1):
        for j, ids in enumerate(per_doc(out_dir, shard)):
            union[shard + 2 * j] = ids  # shard k holds docs k, k+2, ...
    assert [union[i] for i in range(len(DOCS))] == want


def test_single_process_never_touches_the_backend(monkeypatch):
    import torch.distributed as dist

    for name in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)

    def refuse(*a, **k):
        raise AssertionError("the backend was touched")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "all_reduce", refuse)
    multihost.initialize()
    assert not multihost.in_distributed_job()
    assert multihost.process_info() == (0, 1)
    out = multihost.all_sum([3, 5.5])
    assert out.dtype == np.float64 and out.tolist() == [3.0, 5.5]


def test_launcher_environment_alone_gives_the_rank(monkeypatch):
    """Under a launcher, before any group exists, the rank still comes
    from the environment; a world size without a rank raises."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert multihost.in_distributed_job()
    assert multihost.process_info() == (3, 4)
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="RANK"):
        multihost.process_info()
    with pytest.raises(ValueError, match="rank"):
        multihost.initialize()
