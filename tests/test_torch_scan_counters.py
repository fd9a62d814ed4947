"""The native scanner's counters (``runtime.native.SCAN_COUNTERS``) on the CPU.

``GpuTokenizer`` passes one accumulating counter array (``stats.scan``)
to every native split call and batched host merge.  Here the calls are
watched one by one while ``encode_batch_stream`` runs a cold and then a
warm pass over ``chip_smoke.gen_corpus(0.5, seed)`` with one piece over
the merge's widest bucket added (:func:`corpus`) in chunks of 16
documents, on three routes: default, every wave on the host
(``chip_smoke.host_reference``) and every wave on the merge (forced, the
plain PyTorch merge here).  Each call's counters must agree with what the
call returned: its inserts with the growth of the interning table, its
fused merges by class with its ``n_fused``, its deferred news with its
news, its holes with its patches, and the batched merge's pieces with the
pieces it was handed.  A warm pass counts no first-seen work, the counts
do not depend on the thread count, no time is negative, and the ids with
the counters on are still the committed goldens.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import find_testdata, require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch.runtime import native
from tokenizer_tpu_torch.runtime.native import SCAN_COUNTERS, SplitContext

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import gen_corpus, host_reference  # noqa: E402

SEEDS = (0, 1)
ROUTES = ("default", "host", "forced")
CHUNK_DOCS = 16
#: counters of first-seen work: zero on a warm pass.
FIRST_SEEN = (
    "intern_locks", "inserts", "intern_s", "intern_wait_s", "rebuilds", "rebuild_s",
    "fused_short", "fused_short_bytes", "fused_short_s",
    "fused_long", "fused_long_bytes", "fused_long_s",
    "gen_copies", "gen_copy_bytes", "gen_copy_s",
    "defer_off", "defer_capacity", "defer_wide", "patches",
    "bpe_calls", "bpe_pieces", "bpe_bytes", "bpe_merge_s", "bpe_call_s", "bpe_longest_s",
)
#: counts that follow from the input and the route alone, not from the
#: thread count (holes, staged resolves and lock acquisitions depend on
#: which thread meets a piece first).
DETERMINED = (
    "calls", "inserts",
    "fused_short", "fused_short_bytes", "fused_long", "fused_long_bytes",
    "gen_copies", "gen_copy_bytes", "defer_off", "defer_capacity", "defer_wide",
    "bpe_calls", "bpe_pieces", "bpe_bytes",
)
SPLITS = ("split_batch", "split_merge_batch", "split_emit_batch")
DEFERRED = ("defer_off", "defer_capacity", "defer_wide")


def make_tok(route: str):
    if route == "host":
        return host_reference("cl100k_synth")
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu", mesh=None)
    return forced(tok) if route == "forced" else tok


class Calls:
    """Every native split call and batched merge of the port, with the
    change of the counters it was given and what it returned."""

    def __init__(self, monkeypatch):
        self.seen: list = []
        for name in SPLITS:
            monkeypatch.setattr(SplitContext, name, self._split(name, getattr(SplitContext, name)))
        monkeypatch.setattr(native, "bpe_encode_batch_spans", self._bpe(native.bpe_encode_batch_spans))

    def _split(self, name, real):
        def call(ctx, *a, counters=None, **k):
            n0, c0 = ctx.n_pieces, counters.copy()
            out = real(ctx, *a, counters=counters, **k)
            self.seen.append({"call": name, "out": out, "grew": ctx.n_pieces - n0,
                              "counted": native.scan_report(counters - c0)})
            return out

        return call

    def _bpe(self, real):
        def call(buf, starts, ends, table, *a, counters=None, **k):
            c0 = counters.copy()
            out = real(buf, starts, ends, table, *a, counters=counters, **k)
            self.seen.append({"call": "bpe_encode_batch_spans", "pieces": len(starts),
                              "counted": native.scan_report(counters - c0)})
            return out

        return call


_RUNS: dict = {}


@pytest.fixture
def run(monkeypatch):
    """``run(seed, route, threads)``: the calls and counter totals of a cold
    and a warm stream pass at ``TOKENIZER_TPU_THREADS=threads``, each
    pass's ids held to the host engine's (computed once per module)."""
    require_vocab("cl100k_synth")

    def go(seed: int, route: str, threads: int = 8) -> dict:
        key = (seed, route, threads)
        if key not in _RUNS:
            docs = corpus(seed)
            chunks = [docs[i : i + CHUNK_DOCS] for i in range(0, len(docs), CHUNK_DOCS)]
            want = _reference(seed, docs)
            with monkeypatch.context() as m:
                m.setenv("TOKENIZER_TPU_THREADS", str(threads))
                calls = Calls(m)
                tok = make_tok(route)
                passes = {}
                for p in ("cold", "warm"):
                    at, c0 = len(calls.seen), tok.stats.scan.copy()
                    got = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, w)
                    passes[p] = {"calls": calls.seen[at:],
                                 "total": native.scan_report(tok.stats.scan - c0)}
            _RUNS[key] = {"passes": passes, "stats": tok.stats.as_dict()}
        return _RUNS[key]

    return go


def corpus(seed: int) -> list:
    """``gen_corpus(0.5, seed)`` and, in its middle, a run of 700 CJK
    ideographs: one piece of 2,100 bytes.  The corpus's own longest pieces
    (its CJK runs, at most 1,797 bytes) merge on the device route's
    widest bucket (``MAX_L``), so without it the forced route would hand
    the batched native merge nothing."""
    docs = gen_corpus(0.5, seed, (REPO / "tests" / "testdata" / "lib.rs.txt").read_text())
    rng = np.random.default_rng(seed)
    docs.insert(len(docs) // 2, "".join(map(chr, rng.integers(0x4E00, 0x56D0, size=700))) + " tail")
    return docs


_REFS: dict = {}


def _reference(seed: int, docs: list) -> list:
    if seed not in _REFS:
        host = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=None)
        _REFS[seed] = [np.asarray(host.encode(d), np.int32) for d in docs]
    return _REFS[seed]


CASES = [(s, r) for s in SEEDS for r in ROUTES]


def test_the_native_library_is_abi_12():
    """The library the port loads is the one whose calls take counters: a
    version mismatch would quietly turn the native path off."""
    assert native.available()
    assert native._load().tt_abi_version() == native.ABI_VERSION == 12
    assert len(SCAN_COUNTERS) == len(set(SCAN_COUNTERS)) == native.scan_counters().size


@pytest.mark.parametrize("seed,route", CASES)
def test_inserts_are_the_growth_of_the_interning_table(run, seed, route):
    calls = [c for c in run(seed, route)["passes"]["cold"]["calls"] if c["call"] in SPLITS]
    assert calls and sum(c["grew"] for c in calls) > 0
    for c in calls:
        assert c["counted"]["inserts"] == c["grew"], c["call"]


@pytest.mark.parametrize("seed,route", CASES)
def test_fused_merges_by_class_add_up_to_n_fused(run, seed, route):
    fused = 0
    for c in run(seed, route)["passes"]["cold"]["calls"]:
        if c["call"] in ("split_merge_batch", "split_emit_batch") and not isinstance(c["out"][0], str):
            n_fused = c["out"][5] if c["call"] == "split_merge_batch" else c["out"][6]
            k = c["counted"]
            assert k["fused_short"] + k["fused_long"] + k["gen_copies"] == n_fused, c["call"]
            fused += n_fused
    stats = run(seed, route)["stats"]
    assert fused == stats["fused_pieces"]
    assert (fused > 0) == (route != "forced")


@pytest.mark.parametrize("seed,route", CASES)
def test_deferred_news_and_holes_are_what_the_call_returned(run, seed, route):
    """A call's deferred pieces, by every reason, are its news; its holes
    are its patches (a call whose patches overflowed returns no patches)."""
    total = dict.fromkeys(DEFERRED, 0)
    for c in run(seed, route)["passes"]["cold"]["calls"]:
        if c["call"] not in SPLITS:
            continue
        k, out = c["counted"], c["out"]
        news = out[1] if isinstance(out[0], str) else out[3] if c["call"] != "split_emit_batch" else out[4]
        assert sum(k[d] for d in DEFERRED) == len(news[0]), c["call"]
        if c["call"] == "split_emit_batch" and not isinstance(out[0], str):
            assert k["patches"] == len(out[8][0])
        for d in DEFERRED:
            total[d] += k[d]
    if route == "forced":  # the device route's scan fuses nothing
        assert total["defer_off"] == run(seed, route)["stats"]["scan_inserts"] > 0
    if route == "host":
        assert total["defer_off"] == 0


@pytest.mark.parametrize("seed,route", CASES)
def test_the_batched_merge_counts_the_pieces_it_was_handed(run, seed, route):
    calls = [c for c in run(seed, route)["passes"]["cold"]["calls"]
             if c["call"] == "bpe_encode_batch_spans"]
    assert calls  # oversized pieces, or host waves
    for c in calls:
        assert c["counted"]["bpe_pieces"] == c["pieces"] and c["counted"]["bpe_calls"] == 1
        assert c["counted"]["bpe_bytes"] >= c["pieces"]


@pytest.mark.parametrize("seed,route", CASES)
def test_a_warm_pass_counts_no_first_seen_work(run, seed, route):
    warm = run(seed, route)["passes"]["warm"]["total"]
    assert {k: warm[k] for k in FIRST_SEEN} == dict.fromkeys(FIRST_SEEN, 0)
    assert warm["calls"] > 0 and warm["busy_s"] > 0 and warm["staged"] >= 0
    cold = run(seed, route)["passes"]["cold"]["total"]
    assert cold["inserts"] > 0 and cold["intern_s"] > 0 and cold["bpe_pieces"] > 0


@pytest.mark.parametrize("seed,route", CASES)
def test_counts_do_not_depend_on_the_thread_count(run, seed, route):
    one, eight = (run(seed, route, t)["passes"] for t in (1, 8))
    for p in ("cold", "warm"):
        assert {k: one[p]["total"][k] for k in DETERMINED} == \
            {k: eight[p]["total"][k] for k in DETERMINED}, p
        for r in (one, eight):
            t = r[p]["total"]
            assert all(v >= 0 for v in t.values()), p
            assert t["intern_wait_s"] <= t["intern_s"] and t["rebuild_s"] <= t["intern_s"]
            assert t["busiest_s"] <= t["busy_s"] and t["bpe_longest_s"] <= t["bpe_merge_s"]
    assert one["cold"]["total"]["workers"] == one["cold"]["total"]["calls"]


@pytest.mark.parametrize("route", ROUTES)
def test_goldens_with_the_counters_on(route):
    """lib.rs.txt's ids equal the committed Rust tiktoken goldens while
    every native call counts."""
    require_vocab("cl100k_synth")
    text = (REPO / "tests" / "testdata" / "lib.rs.txt").read_text(encoding="utf-8")
    want = json.loads(find_testdata("tokens_cl100k_synth.json").read_text())
    tok = make_tok(route)
    (ids,) = tok.encode_batch([text])
    assert list(ids) == want
    stats = tok.stats.as_dict()
    assert stats["scan_inserts"] == tok._split_ctx.n_pieces > 0
    assert set(stats) >= {f"scan_{n}" for n in SCAN_COUNTERS}
