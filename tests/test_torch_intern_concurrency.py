"""The port scanner's intern table under concurrent first-seen pieces, on the CPU.

Each scan worker inserts the pieces it meets first into one table that
every worker reads (``presplit.cpp``: a slot is claimed by a
compare-and-swap, its uid published last; ``Ctx::mu`` only grows the
table).  Two inputs, made from a seed with numpy:

- **collide**: 100 segments of 150 fresh words and 150 of a shared pool
  of 2,000, each segment listed 4 times in a row, so that several
  threads meet the same first-seen pieces at once;
- **grow**: 90,000 fresh pieces (half of 3-8 bytes, half of 41-71 bytes)
  in 90 segments listed twice: more than 70,000 distinct pieces in one
  call, so the slots and the arena grow mid-call.

At 1, 2, 8 and 16 threads, over several rounds, a fresh
``SplitContext`` splits collide, grow and collide again
(``split_batch``).  After every call: uids are dense and one-to-one with
the piece bytes, within the call and across calls; every fresh uid is
reported once, with its own bytes; ``n_pieces`` and the ``inserts``
counter equal the distinct pieces seen; the pieces are the JAX package's
native scanner's, and its uids (one thread) partition them the same way.
Then a host-routed tokenizer encodes the documents at each thread count
(``split_emit_batch``, first-seen pieces merged in the scan), and its ids
must equal Rust tiktoken's.  Last, ``tests/intern_stress.cpp`` drives the
same stress through a ThreadSanitizer build of the port's
``presplit.cpp``, which must report nothing, and then the fused calls
(``tt_ctx_split_merge_batch`` and ``tt_ctx_split_emit_batch``) at 8
threads, with ``defer_len`` 0 and 6 and a row matrix that holds every
first-seen piece or only part of them, so that the workers race for the
row matrix's tail (``FuseState::row_next``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import require_vocab

from tokenizer_tpu.runtime import native as jax_native
from tokenizer_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

THREADS = (1, 2, 8, 16)
ROUNDS = 3
PATTERN = native.PATTERN_IDS["p2"]  # cl100k: " word" is one piece
TSAN_ROUNDS = 1


def _fresh(rng, n: int, lo: int, hi: int, used: set) -> list:
    """``n`` pieces " word" of ``lo``-``hi`` letters, none in ``used``."""
    out: list = []
    while len(out) < n:
        k = n - len(out)
        lens = rng.integers(lo, hi + 1, k)
        letters = rng.integers(ord("a"), ord("z") + 1, int(lens.sum()), dtype=np.uint8).tobytes()
        ends = np.cumsum(lens)
        for a, b in zip(ends - lens, ends):
            w = " " + letters[a:b].decode()
            if w not in used:
                used.add(w)
                out.append(w)
    return out


def _inputs(seed: int = 15) -> dict:
    rng = np.random.default_rng(seed)
    used: set = set()
    pool = _fresh(rng, 2000, 2, 11, used)
    collide = []
    for _ in range(100):
        own = _fresh(rng, 150, 2, 11, used)
        picks = rng.integers(0, len(pool), 150)
        collide += ["".join(w + pool[p] for w, p in zip(own, picks))] * 4
    shorts = _fresh(rng, 45000, 2, 7, used)
    longs = _fresh(rng, 45000, 40, 70, used)
    grow = []
    for s in range(90):
        grow += ["".join(a + b for a, b in zip(shorts[s * 500 : s * 500 + 500],
                                               longs[s * 500 : s * 500 + 500]))] * 2
    return {"collide": collide, "grow": grow}


class Case:
    """One input as the split calls take it, with its pieces as the JAX
    package's native scanner cuts them, each as a key: one int per
    distinct piece, shared by every input."""

    def __init__(self, docs: list, keys: dict):
        datas = [d.encode() for d in docs]
        self.buf = b"".join(datas)
        lens = np.array([len(d) for d in datas], np.int64)
        self.ends = np.cumsum(lens)
        self.starts = self.ends - lens
        key, cut = [], {}
        for d in datas:
            if d not in cut:
                e = jax_native.presplit(d, PATTERN)
                s = np.concatenate([[0], e[:-1]])
                cut[d] = [keys.setdefault(d[a:b], len(keys)) for a, b in zip(s, e)]
            key += cut[d]
        self.key = np.array(key, np.int64)

    def uids(self, ctx, threads: int):
        """One ``split_batch`` call: every occurrence's uid, the news, the counters."""
        counters = native.scan_counters() if isinstance(ctx, native.SplitContext) else None
        kw = {"counters": counters} if counters is not None else {}
        buf, offs, counts, news = ctx.split_batch(self.buf, self.starts, self.ends,
                                                  nthreads=threads, **kw)
        u = np.concatenate([buf[o : o + c] for o, c in zip(offs, counts)]).astype(np.int64)
        return u, tuple(np.array(x) for x in news), counters


@pytest.fixture(scope="module")
def cases():
    keys: dict = {}
    docs = _inputs()
    order = ("collide", "grow", "collide")
    made = {name: Case(docs[name], keys) for name in ("collide", "grow")}
    # The JAX package's scanner, one thread: its uids of each call in turn.
    ref = jax_native.SplitContext(PATTERN)
    jax_uids = [made[name].uids(ref, 1)[0] for name in order]
    return {"docs": docs, "keys": keys, "calls": [(name, made[name]) for name in order],
            "jax_uids": jax_uids}


def _one_to_one(a: np.ndarray, b: np.ndarray) -> bool:
    pairs = np.unique(np.stack([a, b]), axis=1)
    return pairs.shape[1] == len(np.unique(a)) == len(np.unique(b))


def test_inputs_are_what_the_stress_needs(cases):
    (_, collide), (_, grow), _ = cases["calls"]
    assert len(np.unique(grow.key)) > 70_000
    assert len(np.setdiff1d(grow.key, collide.key)) > 70_000
    # each collide segment four times in a row, its own words in it
    assert cases["docs"]["collide"][0] == cases["docs"]["collide"][3] != cases["docs"]["collide"][4]


@pytest.mark.parametrize("threads", THREADS)
def test_uids_are_dense_one_to_one_and_reported_once(cases, threads):
    inv = {v: k for k, v in cases["keys"].items()}
    for _ in range(ROUNDS):
        ctx = native.SplitContext(PATTERN)
        uid_key = np.full(len(cases["keys"]), -1, np.int64)  # by uid
        reported = np.zeros(len(cases["keys"]), bool)
        seen = set()
        for (name, case), jax_u in zip(cases["calls"], cases["jax_uids"]):
            before = ctx.n_pieces
            u, (nu, ns, ne), counters = case.uids(ctx, threads)
            n = ctx.n_pieces
            assert len(u) == len(case.key), name
            assert _one_to_one(u, case.key), name
            assert _one_to_one(u, jax_u), name
            assert u.min() >= 0 and u.max() < n, name
            old = uid_key[u] >= 0
            assert np.array_equal(uid_key[u[old]], case.key[old]), name
            uid_key[u] = case.key
            seen.update(np.unique(case.key).tolist())
            assert n == len(seen) and (uid_key[:n] >= 0).all(), name  # dense
            # every fresh uid reported once, with its own bytes
            assert len(nu) == n - before == native.scan_report(counters)["inserts"], name
            assert len(np.unique(nu)) == len(nu) and not reported[nu].any(), name
            assert ((nu >= before) & (nu < n)).all(), name
            reported[nu] = True
            got = [case.buf[a:b] for a, b in zip(ns, ne)]
            assert got == [inv[k] for k in uid_key[nu]], name
        assert reported[: ctx.n_pieces].all()


@pytest.mark.parametrize("threads", THREADS)
def test_ids_equal_tiktoken(cases, threads, monkeypatch):
    require_vocab("cl100k_synth")
    from chip_smoke import host_reference
    from synth_goldens import rust_encoding

    docs = cases["docs"]["collide"] + cases["docs"]["grow"]
    if "want" not in cases:
        enc = rust_encoding("cl100k_synth")
        cases["want"] = [np.asarray(x, np.int32) for x in enc.encode_ordinary_batch(docs)]
    monkeypatch.setenv("TOKENIZER_TPU_THREADS", str(threads))
    tok = host_reference("cl100k_synth")
    for _ in range(2):  # cold, then warm
        got = tok.encode_batch(docs)
        assert len(got) == len(docs)
        bad = [i for i, (g, w) in enumerate(zip(got, cases["want"])) if not np.array_equal(g, w)]
        assert not bad, f"documents {bad[:5]} differ from tiktoken"
    stats = tok.stats.as_dict()
    assert stats["scan_inserts"] == tok._split_ctx.n_pieces == len(cases["keys"])


def test_thread_sanitizer_finds_no_race():
    """``tests/intern_stress.cpp`` against a ThreadSanitizer build of the
    port's ``presplit.cpp`` (built under ``build/tsan/``): the unfused
    split, then the fused calls with and without ``defer_len``."""
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        pytest.skip(f"no {cxx}")
    src = REPO / "tokenizer_tpu_torch" / "runtime" / "native" / "presplit.cpp"
    drv = REPO / "tests" / "intern_stress.cpp"
    out = REPO / "build" / "tsan"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / f"intern_stress-{os.getpid()}"
    flags = ["-std=c++17", "-pthread", "-fno-exceptions"]
    obj, dobj = out / f"presplit-{os.getpid()}.o", out / f"driver-{os.getpid()}.o"
    # The driver's own checks run uninstrumented (it reads the scanner's
    # output only after the call has joined its threads).
    for cmd in ([cxx, *flags, "-O1", "-g", "-fsanitize=thread", "-c", str(src), "-o", str(obj)],
                [cxx, *flags, "-O2", "-c", str(drv), "-o", str(dobj)],
                [cxx, "-fsanitize=thread", "-pthread", str(obj), str(dobj), "-o", str(exe)]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    env = {**os.environ, "TSAN_OPTIONS": "halt_on_error=1 exitcode=66"}
    try:
        run = subprocess.run([str(exe), str(TSAN_ROUNDS)], capture_output=True, text=True,
                             timeout=600, env=env)
    finally:
        for f in (exe, obj, dobj):
            f.unlink(missing_ok=True)
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-4000:]
    assert run.returncode == 0, (run.stdout, run.stderr[-4000:])
    assert run.stdout.startswith("ok calls 12 "), run.stdout
    assert " fused_calls 8 " in run.stdout, run.stdout
