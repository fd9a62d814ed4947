"""The port's wave router and the scanner's ``defer_len`` on the CPU.

``GpuTokenizer`` fuses a first-seen piece of at most ``gpu.L_HOST`` bytes
into the native scan and leaves each longer one to the chunk's wave,
which ``_route_wave_host`` sends to the host's batched merge if it holds
at most ``gpu.HOST_WAVE_MAX`` pieces, else to the card (both numbers
measured by ``tools/router_crossover.py``).  Here:

- the rule, as a function of piece lengths (where each piece of a chunk
  merges), the threshold, and the two forcing settings (``chip_smoke.forced``: every
  piece to the merge, none fused; ``_host_wave_max = sys.maxsize``: every
  piece on the host);
- the scanner: ``defer_len = 0`` gives the counters and outputs that the
  ABI 13 scanner gave on the same input (``tests/fused_abi13.json``,
  written by ``tools/fused_golden.py``); with ``defer_len > 0`` its
  ``defer_long`` counter is the first-seen pieces longer than it, each of
  them in the news unmerged;
- a cold ``encode_batch_stream`` at default routing on ``device="cpu"``
  over chunks with CJK runs makes one split call a chunk, sends the long
  pieces to the merge (the plain PyTorch merge here), and its ids equal
  the JAX ``TpuTokenizer``'s and Rust tiktoken's, lib.rs.txt's equal to
  the committed golden.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import find_testdata, require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch import gpu
from tokenizer_tpu_torch.parallel import data_mesh
from tokenizer_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import fused_golden  # noqa: E402
import synth_goldens  # noqa: E402
from chip_smoke import gen_corpus, host_reference  # noqa: E402

NAME = "cl100k_synth"


def _tok(**kw):
    require_vocab(NAME)
    return tt.create_by_encoder_name(NAME, allow_fetch=False, device="cpu", mesh=None, **kw)


def _pieces(tag, lengths) -> str:
    """A text of distinct letter pieces of these byte ``lengths``: each a
    space and letters (one regex piece), led by its index in base 26, all
    indices of one width, so no two are equal."""
    out = []
    width = 1
    while 26**width < len(lengths):
        width += 1
    for j, n in enumerate(lengths):
        head = "".join(chr(97 + j // 26**i % 26) for i in range(width))
        h = hashlib.blake2b(f"{tag}:{j}".encode(), digest_size=64).digest() * (n // 64 + 1)
        body = head + "".join(chr(97 + b % 26) for b in h[: n - 1 - len(head)])
        assert len(body) == n - 1, "a piece too short for its index"
        out.append(" " + body)
    return "".join(out)


#: waves by their pieces' lengths: each class alone at several sizes, mixes,
#: and pieces over MAX_L.
WAVES = {
    "one short": [5],
    "4,000 short": [5, 7, 12, 16] * 1000,
    "64 of 17-128": list(range(17, 81)),
    "one of 600": [600],
    "8 of 600": [600] * 8,
    "64 of 600": [600] * 64,
    "128 of 1,500": [1500] * 128,
    "a stream chunk's long pieces": [700] * 19 + [1500] * 38,
    "short and long": [4] * 3000 + [900] * 40,
    "over MAX_L": [3000] * 4,
}


@pytest.mark.parametrize("deferred", [True, False])
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_a_wave_is_priced_by_its_pieces_lengths(wave, deferred):
    """Where a first-seen piece merges, as a function of the lengths of the
    pieces of its chunk: one of at most ``L_HOST`` bytes in the scan; the
    longer ones in one wave, on the host if they are at most
    ``HOST_WAVE_MAX``, else on the (plain) merge, the pieces over ``MAX_L``
    on the host either way.  The same through ``encode_batch_stream``
    (``deferred``: the wave finishes behind the next scan) and
    ``encode_batch`` (at once); the ids equal Rust tiktoken's."""
    tok = _tok()
    lengths = np.array(WAVES[wave])
    text = _pieces(wave, lengths)
    if deferred:
        (ids,) = [ids for batch in tok.encode_batch_stream(iter([[text]])) for ids in batch]
    else:
        (ids,) = tok.encode_batch([text])
    assert list(ids) == synth_goldens.rust_encoding(NAME).encode_ordinary(text)
    short, long_ = int((lengths <= gpu.L_HOST).sum()), lengths[lengths > gpu.L_HOST]
    st = tok.stats
    assert st.unique_pieces == len(lengths) and st.fused_pieces == short
    if len(long_) <= gpu.HOST_WAVE_MAX:
        assert st.device_waves == st.device_pieces == st.host_fallback_pieces == 0
        assert st.host_wave_pieces == len(lengths)
    else:
        assert st.device_waves == 1 and st.host_wave_pieces == short
        assert st.device_pieces == int((long_ <= gpu.MAX_L).sum())
        assert st.host_fallback_pieces == int((long_ > gpu.MAX_L).sum())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 64, 20000])
def test_a_wave_of_at_most_host_wave_max_pieces_stays_on_the_host(n):
    """The measured threshold (``HOST_WAVE_MAX``, ``tools/router_crossover.py``):
    one to four pieces on the host, more on the card."""
    tok = _tok()
    assert gpu.HOST_WAVE_MAX == tok._host_wave_max == 4
    assert tok._route_wave_host(n) is (n <= gpu.HOST_WAVE_MAX)


def test_the_scan_fuses_up_to_l_host():
    """At default routing the scan fuses first-seen pieces of at most
    ``L_HOST`` bytes, whatever finite value ``_host_pp`` holds."""
    tok = _tok()
    assert tok._scan_defer_len() == gpu.L_HOST == 16
    tok._host_pp = 1e6
    assert tok._scan_defer_len() == gpu.L_HOST


def test_the_host_s_scale_moves_the_rule():
    """``_host_pp = inf`` turns fusing off and leaves the wave threshold as
    it is: every first-seen piece reaches a wave, routed by its size."""
    tok = _tok()
    tok._host_pp = float("inf")
    assert tok._scan_defer_len() is None
    assert tok._route_wave_host(gpu.HOST_WAVE_MAX) and not tok._route_wave_host(gpu.HOST_WAVE_MAX + 1)
    text = _pieces("inf", [5] * 40)
    (ids,) = tok.encode_batch([text])
    assert list(ids) == synth_goldens.rust_encoding(NAME).encode_ordinary(text)
    assert tok.stats.fused_pieces == 0 and tok.stats.device_pieces == 40


def test_forced_sends_every_piece_to_the_card_unfused():
    tok = forced(_tok())
    assert tok._scan_defer_len() is None
    for n in (1, gpu.HOST_WAVE_MAX, 64, 20000):
        assert tok._route_wave_host(n) is False


def test_the_host_setting_keeps_every_piece_on_the_host():
    tok = host_reference(NAME)
    assert tok._scan_defer_len() == gpu.L_HOST
    for n in (0, 1, gpu.HOST_WAVE_MAX + 1, 64, 20000):
        assert tok._route_wave_host(n) is True
    text = "前" * 400 + " a few short words " + "x" * 300 + _pieces("host", [700] * 8)
    (ids,) = tok.encode_batch([text])
    assert list(ids) == synth_goldens.rust_encoding(NAME).encode_ordinary(text)
    st = tok.stats
    assert st.device_pieces == 0 and st.host_wave_pieces == st.unique_pieces > st.fused_pieces > 0


def test_a_mesh_fuses_nothing_and_routes_every_wave_to_its_shards():
    require_vocab(NAME)
    tok = tt.create_by_encoder_name(NAME, allow_fetch=False, device="cpu",
                                    mesh=data_mesh(devices=["cpu"] * 2))
    assert tok._scan_defer_len() is None
    assert tok._route_wave_host(1) is False


# -- the scanner ------------------------------------------------------------


def _abi13() -> dict:
    return json.loads((REPO / "tests" / "fused_abi13.json").read_text())


def test_defer_len_0_gives_what_abi_13_gave():
    """Every call of the fixed input, ``defer_len = 0``: the same counts
    (every slot but the times; ``defer_long``, new in ABI 14, 0), the same
    ``n_fused``, rows, news and patches, and the same SHA-256 of the ids,
    news, patches and rows as the ABI 13 library's record."""
    require_vocab(NAME)
    tok = _tok()
    want = _abi13()
    assert want["abi"] == 13 and native.ABI_VERSION == 14
    got = fused_golden.record(native, tok.table, tok._native_pid, defer_len=0)
    assert set(got) == set(want["calls"])
    for call, rec in got.items():
        assert rec["counts"].pop("defer_long") == 0, call
        assert rec == want["calls"][call], call


def _split_news(call: str, defer_len: int):
    """One fused call of ``fused_golden.docs()`` on a fresh context, rows to
    spare: (its counters, its news' byte lengths, every first-seen piece's
    length, its n_fused)."""
    tok = _tok()
    datas = [d.encode("utf-8") for d in fused_golden.docs()]
    buf = b"".join(datas)
    lens = np.array([len(d) for d in datas], dtype=np.int64)
    ends = np.cumsum(lens)
    starts = ends - lens
    _, _, _, (uids, s, e) = native.SplitContext(tok._native_pid).split_batch(buf, starts, ends)
    seen = e - s
    ctx = native.SplitContext(tok._native_pid)
    n = len(buf)
    rows = np.zeros((n, 128), np.int32)
    args = (buf, starts, ends, tok.table, rows, np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.full(n, -1, np.int32), 0)
    c = native.scan_counters()
    res = getattr(ctx, call)(*args, uid_ids=np.zeros((n, 8), np.int32), counters=c,
                             defer_len=defer_len)
    news = res[3] if call == "split_merge_batch" else res[4]
    n_fused = res[5] if call == "split_merge_batch" else res[6]
    return native.scan_report(c), news[2] - news[1], seen, n_fused


@pytest.mark.parametrize("defer_len", [1, 8, 64, 128, 400, 1000])
@pytest.mark.parametrize("call", ["split_merge_batch", "split_emit_batch"])
def test_defer_long_is_the_first_seen_pieces_longer_than_defer_len(call, defer_len):
    counted, news, seen, n_fused = _split_news(call, defer_len)
    longer = int((seen > defer_len).sum())
    assert counted["defer_long"] == longer == int((news > defer_len).sum())
    assert counted["inserts"] == len(seen) == n_fused + len(news)
    assert counted["defer_long"] + counted["defer_wide"] + counted["defer_capacity"] == len(news)
    assert counted["defer_capacity"] == 0
    if defer_len <= 128:  # no piece of at most a row's width can be wider than a row
        assert counted["defer_wide"] == 0


# -- the main path: one scan a chunk --------------------------------------


def _stream_docs(seed: int) -> list:
    """``gen_corpus(0.3, seed)`` with 60 CJK runs of 600-1,800 bytes at
    three places, and lib.rs.txt as a document of its own."""
    docs = gen_corpus(0.3, seed, (REPO / "tests" / "testdata" / "lib.rs.txt").read_text())
    rng = np.random.default_rng(seed)
    for at in (0, len(docs) // 3, 2 * len(docs) // 3):
        docs[at:at] = ["".join(map(chr, rng.integers(0x4E00, 0x56D0, size=int(k)))) + " 尾"
                       for k in rng.integers(200, 600, size=20)]
    docs.insert(len(docs) // 2, (REPO / "tests" / "testdata" / "lib.rs.txt").read_text())
    return docs


@pytest.mark.parametrize("seed", [0, 1])
def test_a_cold_stream_scans_each_chunk_once(seed):
    """Default routing, ``device="cpu"``, 32 documents a chunk: one native
    split call a chunk, the chunks' long pieces merged on the (plain) merge
    and no wide fused piece merged twice above ``L_HOST``; the ids equal
    Rust tiktoken's, the JAX ``TpuTokenizer``'s on its CPU mesh, and
    lib.rs.txt's the committed golden."""
    from tokenizer_tpu import create_by_encoder_name as create_jax

    docs = _stream_docs(seed)
    chunks = [docs[i : i + 32] for i in range(0, len(docs), 32)]
    tok = _tok()
    calls0 = native.scan_report(tok.stats.scan)["calls"]
    got = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    scan = native.scan_report(tok.stats.scan)
    assert scan["calls"] - calls0 == len(chunks)
    st = tok.stats
    assert st.device_waves > 0 and st.device_long_pieces > 0 and st.fused_pieces > 0
    assert scan["defer_long"] > 0 and scan["defer_off"] == 0
    want = [synth_goldens.rust_encoding(NAME).encode_ordinary(d) for d in docs]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == w
    jax_tok = create_jax(NAME, allow_fetch=False, use_tpu=True)
    for g, j in zip(got, jax_tok.encode_batch(docs)):
        np.testing.assert_array_equal(g, j)
    golden = json.loads(find_testdata("tokens_cl100k_synth.json").read_text())
    lib = docs.index((REPO / "tests" / "testdata" / "lib.rs.txt").read_text())
    assert list(got[lib]) == golden


def test_the_first_chunk_s_row_reserve_is_the_measured_rate():
    """A fresh tokenizer reserves rows for its first chunk from
    ``NEWS_PER_BYTE``, not the TPU package's 1/32."""
    tok = _tok()
    assert tok._news_per_byte == gpu.NEWS_PER_BYTE < 1 / 100


def test_router_crossover_runs_on_the_cpu(tmp_path):
    """``tools/router_crossover.py`` at a tiny size on the CPU (the card's
    route is the plain merge here): every routing's ids equal tiktoken's
    (checked inside), the default routing scans each chunk once, every
    class has its host and card fits, and the record is written."""
    import router_crossover

    require_vocab(NAME)
    out = tmp_path / "rc.json"
    assert router_crossover.main(["--mb", "0.05", "--rounds", "1", "--sizes", "1,2", "--device", "cpu",
                                  "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    routings = {r["routing"]: r["runs"][0] for r in rec["routings"]}
    assert set(routings) == set(router_crossover.ROUTINGS)
    assert routings["default"]["split_calls"] == routings["default"]["chunks"] == rec["chunks"]
    assert routings["card"]["fused_pieces"] == 0 and routings["host"]["device_pieces"] == 0
    classes = [list(c) for c in router_crossover.CLASSES]
    assert [h["class"] for h in rec["host"]] == [d["class"] for d in rec["device_waves"]] == classes
    assert all(c["pieces"] + c["synthesized"] >= router_crossover.TOP_UP
               for c in rec["pieces"]["classes"])
    assert rec["crossover"]["L_host"] in (0, *(hi for _, hi in router_crossover.CLASSES))
    assert rec["crossover"]["host_wave_max"] in (0, 1, 2)
    assert rec["card"] == "cpu (no card)"
