"""GpuTokenizer's bulk pipeline vs the port's host engine, exactly.

The counterpart of ``tests/test_tpu_pipeline.py``, case for case: each
test's docstring names its JAX test.  ``device="cpu"`` runs the port's
device plumbing with the plain PyTorch merge, and every wave is forced
onto it (``_host_pp = inf``, ``_host_wave_max = 0``) unless the JAX test
asserts a routing decision.  The reference is the port's host
``TikTokenizer``, as the JAX file's is the JAX package's.
"""

import hashlib
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from conftest import require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch.engine import TikTokenizer
from tokenizer_tpu_torch import gpu
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.models.registry import get_encoding_spec
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.parallel.mesh import data_mesh, local_devices
from tokenizer_tpu_torch.vocab import Vocabulary


def _port(name="gpt2", force=True, **options):
    require_vocab(name)
    tok = tt.create_by_encoder_name(name, allow_fetch=False, device="cpu", **options)
    return forced(tok) if force else tok


def _host(name="gpt2", **kw):
    return tt.create_by_encoder_name(name, allow_fetch=False, device=None, **kw)


@pytest.fixture(scope="module")
def pair():
    return _port(), _host()


@pytest.fixture(scope="module")
def vocab():
    require_vocab("gpt2")
    return Vocabulary.for_encoding("gpt2", allow_fetch=False)


def _gpu(vocab, force=True, **kw):
    spec = get_encoding_spec("gpt2")
    tok = GpuTokenizer(vocab, spec.special_tokens, spec.pattern, device="cpu", **kw)
    return forced(tok) if force else tok


def _host_of(vocab):
    spec = get_encoding_spec("gpt2")
    return TikTokenizer(vocab, spec.special_tokens, spec.pattern)


def _word(key: str, n: int = 6) -> str:
    h = hashlib.blake2b(key.encode(), digest_size=n).digest()
    return "".join(chr(97 + b % 26) for b in h)


def _assert_match(tok, host, texts, allowed=None):
    got = tok.encode_batch(texts, allowed_special=allowed)
    assert len(got) == len(texts)
    for text, ids in zip(texts, got):
        assert list(ids) == host.encode(text, allowed_special=allowed), repr(text[:60])
    return got


def test_basic_batch(pair):
    """test_tpu_pipeline.py::test_basic_batch"""
    tok, host = pair
    _assert_match(
        tok,
        host,
        [
            "Hello World",
            "",
            "x",
            "  spaces   and\ttabs\n\nnewlines ",
            "unicode ⭐ 💩 你好 é",
            "don't can't I'll they'd",
            "numbers 1 22 333 123456789",
        ],
    )
    assert tok.stats.device_pieces > 0


def test_specials_batch(pair):
    """test_tpu_pipeline.py::test_specials_batch"""
    tok, host = pair
    texts = [
        "<|endoftext|>",
        "a<|endoftext|>b",
        "<|endoftext|><|endoftext|>",
        "no specials here",
    ]
    _assert_match(tok, host, texts, allowed=["<|endoftext|>"])
    _assert_match(tok, host, texts, allowed=None)


def test_oversized_piece_overflow_row(pair):
    """test_tpu_pipeline.py::test_oversized_piece_overflow_row"""
    tok, host = pair
    texts = ["z" * 5000, "ok " + "9" * 300 + " tail", "z" * 5000]
    before = tok.stats.host_fallback_pieces
    _assert_match(tok, host, texts)
    assert tok.stats.host_fallback_pieces > before
    ids = tok.encode_batch(["z" * 5000])[0]
    assert tok.decode(ids) == "z" * 5000


def test_dedup_reuse_across_calls(pair):
    """test_tpu_pipeline.py::test_dedup_reuse_across_calls"""
    tok, host = pair
    u0 = tok.stats.unique_pieces
    _assert_match(tok, host, ["repeat me repeat me repeat me"])
    u1 = tok.stats.unique_pieces
    _assert_match(tok, host, ["repeat me repeat me repeat me"])
    assert tok.stats.unique_pieces == u1
    assert u1 > u0


def test_row_matrix_growth(pair):
    """test_tpu_pipeline.py::test_row_matrix_growth"""
    tok, host = pair
    texts = [" ".join(f"tok{i}x{j}" for j in range(50)) for i in range(60)]
    _assert_match(tok, host, texts)


def test_unreachable_token_force_host():
    """test_tpu_pipeline.py::test_unreachable_token_force_host"""
    enc = {bytes([b]): b for b in range(256)}
    enc[b"xyz"] = 256
    enc[b"ab"] = 257
    specials = {"<|eot|>": 999}
    tok = forced(GpuTokenizer(dict(enc), specials, r"[a-z]+|\s+|.", device="cpu"))
    host = TikTokenizer(dict(enc), specials, r"[a-z]+|\s+|.")
    assert b"xyz" in tok.table.unreachable_tokens
    texts = ["xyz", "ab xyz ab", "xyzxyz"]
    for text, ids in zip(texts, tok.encode_batch(texts)):
        assert list(ids) == host.encode(text), repr(text)
    assert list(tok.encode_batch(["xyz"])[0]) == [256]
    assert tok.stats.host_fallback_pieces >= 1


def test_concurrent_intern_stress(pair):
    """test_tpu_pipeline.py::test_concurrent_intern_stress"""
    tok, host = pair
    rng = random.Random(99)
    texts = [
        " ".join("w%dx%d" % (d, rng.randrange(4000)) for _ in range(400)) for d in range(64)
    ]
    got = tok.encode_batch(texts)
    for text, ids in zip(texts, got):
        assert list(ids) == host.encode(text), text[:60]
    for a, b in zip(got, tok.encode_batch(texts)):
        assert list(a) == list(b)


def test_batch_trims_and_decode_consistency(pair):
    """test_tpu_pipeline.py::test_batch_trims_and_decode_consistency"""
    tok, host = pair
    text = "The quick brown fox ⭐ jumps 1234 over the lazy dog!"
    assert tok.encode(text) == host.encode(text)
    assert tok.encode_trim_suffix(text, 5) == host.encode_trim_suffix(text, 5)
    assert tok.encode_trim_prefix(text, 5) == host.encode_trim_prefix(text, 5)
    ids = tok.encode_batch([text])[0]
    assert tok.decode(ids) == text
    assert tok.decode_batch([ids]) == [text]


def test_encode_batch_stream_matches_encode_batch(pair, lib_rs_text):
    """test_tpu_pipeline.py::test_encode_batch_stream_matches_encode_batch"""
    tok, host = pair
    batches = [
        [lib_rs_text[:3000], "shared piece alpha beta"],
        ["shared piece alpha beta", lib_rs_text[3000:7000]],
        ["⭐ étoile 12345", lib_rs_text[:100]],
    ]
    got = list(tok.encode_batch_stream(iter(batches)))
    want = [tok.encode_batch(b) for b in batches]
    assert len(got) == len(want)
    for g_batch, w_batch, texts in zip(got, want, batches):
        for g, w, t in zip(g_batch, w_batch, texts):
            assert list(g) == list(w) == host.encode(t)


def test_encode_batch_stream_empty(pair):
    """test_tpu_pipeline.py::test_encode_batch_stream_empty"""
    tok, _ = pair
    assert list(tok.encode_batch_stream(iter([]))) == []


def test_single_string_encode_native_scanner_parity(pair, lib_rs_text):
    """test_tpu_pipeline.py::test_single_string_encode_native_scanner_parity"""
    tok, host = pair
    cases = [
        ("", None),
        ("Hello World", None),
        (lib_rs_text, None),
        ("⭐ étoile  123  \t\n mixed   runs", None),
        ("Hello<|endoftext|>World", ["<|endoftext|>"]),
        ("<|endoftext|>" * 3, "all"),
        ("a<|endoftext|>b", None),
    ]
    for text, allowed in cases:
        assert tok.encode(text, allowed) == host.encode(text, allowed), (text[:40], allowed)
    assert tok.encode(lib_rs_text) == host.encode(lib_rs_text)


def test_long_cjk_pieces_through_device_buckets(pair):
    """test_tpu_pipeline.py::test_long_cjk_pieces_through_device_buckets"""
    tok, host = pair
    texts = [
        "".join(chr(0x4E00 + (i * 7) % 2000) for i in range(150)),
        "".join(chr(0x4E00 + (i * 13) % 2000) for i in range(400)),
        "word " + "好" * 300 + " tail",
        "9" * 700,
    ]
    got = tok.encode_batch(texts)
    for g, t in zip(got, texts):
        assert list(g) == host.encode(t)
        assert tok.decode(g) == t


def test_wave_cache_overflow_falls_back_per_tile(vocab, lib_rs_text, monkeypatch):
    """test_tpu_pipeline.py::test_wave_cache_overflow_falls_back_per_tile.
    The port has no wave-combo jit cache (a wave is one upload and one launch
    per tile), so this holds a wave of several buckets to one merge call per
    tile and one upload, with the ids of an unforced tokenizer (taken
    first: its own long pieces go to the merge too)."""
    (want,) = _gpu(vocab, force=False, mesh=None).encode_batch([lib_rs_text[:2000]])
    calls = []
    real = merge_cuda.merge_packed_torch

    def counting(tab, ids, lengths, **kw):
        calls.append(tuple(ids.shape))
        return real(tab, ids, lengths, **kw)

    monkeypatch.setattr(merge_cuda, "merge_packed_torch", counting)
    tok = _gpu(vocab, mesh=None)
    (ids,) = tok.encode_batch([lib_rs_text[:2000]])
    assert list(ids) == list(want)
    assert tok.stats.device_waves == 1 and tok.stats.device_uploads == 1
    assert len(calls) == len({shape[0] for shape in calls}) > 1


def test_small_wave_host_router(vocab):
    """test_tpu_pipeline.py::test_small_wave_host_router (default routing).
    The tiny batch's short pieces merge on the host, in the scan; its one
    piece longer than ``gpu.L_HOST`` (the 700-digit run) is a wave of one,
    at most ``gpu.HOST_WAVE_MAX``, which stays on the host too."""
    tok = _gpu(vocab, force=False, mesh=None)
    host = _host_of(vocab)
    texts = ["a tiny batch with few unique pieces ⭐", "9" * 700]
    for g, t in zip(tok.encode_batch(texts), texts):
        assert list(g) == host.encode(t)
    assert tok._native is not None
    assert tok.stats.host_wave_pieces == tok.stats.fused_pieces + 1 > 1
    assert tok.stats.device_pieces == 0 and tok.stats.device_waves == 0


def test_register_new_uids_unsorted_news():
    """test_tpu_pipeline.py::test_register_new_uids_unsorted_news"""
    tok = _port()
    cap = len(tok._uid_rows)
    base = [f" w{j}x" for j in range(cap - 2)]
    tok.encode_batch(["".join(base)])
    assert len(tok._uid_rows) == cap
    n = tok._split_ctx.n_pieces
    buf = b" zz1x zz0x"
    news = (
        np.array([n + 1, n], np.int32),
        np.array([0, 5], np.int32),
        np.array([5, 10], np.int32),
    )
    wave = tok._register_new_uids_arrays(news, buf)
    assert len(tok._uid_rows) >= n + 2
    rows, starts, ends, wbuf, uids = wave
    assert int(tok._uid_rows[n]) == -1 and int(tok._uid_rows[n + 1]) == -1
    assert sorted(uids.tolist()) == [n, n + 1]
    assert wbuf is buf and list(starts) == [0, 5]
    devices_before = tok.stats.device_waves
    tok._finish_new_piece_rows(tok._dispatch_wave(wave))
    assert tok.stats.device_waves == devices_before + 1
    assert set(rows.tolist()) == {int(tok._uid_rows[n]), int(tok._uid_rows[n + 1])}


def _big_batch(salt_a: int, salt_b: int):
    """40 documents of 80 letter-only words: one first-seen piece a word."""
    return [
        " ".join(_word(f"{i}.{j}.{salt_a}") + _word(f"{j}.{i}.{salt_b}") for j in range(80))
        for i in range(40)
    ]


def _long_runs(tag, n: int = 64) -> str:
    """``n`` first-seen letter runs of 700 bytes: pieces longer than
    ``gpu.L_HOST``, which the scan leaves to the chunk's wave; more than
    ``gpu.HOST_WAVE_MAX`` of them send that wave to the merge."""
    runs = []
    for j in range(n):
        h = hashlib.blake2b(f"{tag}:{j}".encode(), digest_size=64).digest() * 11
        runs.append("".join(chr(97 + b % 26) for b in h[:700]))
    return " " + " ".join(runs)


def test_adaptive_wave_router_gates_on_probe(vocab):
    """test_tpu_pipeline.py::test_adaptive_wave_router_gates_on_probe.
    The port has no channel probe and learns no cost as it runs: its rule
    is measured on the card (``gpu.py``).  Short first-seen words merge in
    the scan, none on the merge; 64 long runs in the same batch leave the
    scan for a wave that goes to the merge; with fusing off
    (``_host_pp = inf``), every first-seen piece goes to the merge."""
    tok = _gpu(vocab, force=False, mesh=None)
    host = _host_of(vocab)
    assert tok._native is not None and tok._host_pp == 1.0
    big = _big_batch(0, 3)
    for g, t in zip(tok.encode_batch(big), big):
        assert list(g) == host.encode(t)
    assert tok.stats.device_pieces == 0
    assert tok.stats.host_wave_pieces == tok.stats.fused_pieces > 1024

    mixed = _big_batch(4, 5)
    mixed[0] += _long_runs("gate")
    for g, t in zip(tok.encode_batch(mixed), mixed):
        assert list(g) == host.encode(t)
    assert tok.stats.device_pieces == 64 and tok.stats.device_waves == 1

    tok._host_pp = float("inf")
    big2 = _big_batch(9, 14)
    for g, t in zip(tok.encode_batch(big2), big2):
        assert list(g) == host.encode(t)
    assert tok.stats.device_pieces > 1024


def test_adaptive_router_explores_after_host_streak(vocab):
    """test_tpu_pipeline.py::test_adaptive_router_explores_after_host_streak.
    The JAX router sends a wave to the device after 32 host waves to
    re-measure it; the port's rule is a function of the wave's size alone,
    so a streak of host waves changes nothing: before and after 40 of them
    (each two long runs beside 20 fused words) a wave of up to
    ``gpu.HOST_WAVE_MAX`` pieces stays on the host and a larger one goes
    to the merge, and that wave's ids are exact."""
    tok = _gpu(vocab, force=False, mesh=None)
    host = _host_of(vocab)
    assert tok._native is not None
    sizes = (1, gpu.HOST_WAVE_MAX, gpu.HOST_WAVE_MAX + 1, 64)
    route = [tok._route_wave_host(n) for n in sizes]
    assert route == [True, True, False, False]
    for k in range(40):
        t = " ".join(_word(f"streak:{k}:{j}") for j in range(20)) + _long_runs(f"streak:{k}", 2)
        (g,) = tok.encode_batch([t])
        assert list(g) == host.encode(t)
    assert tok.stats.device_pieces == 0 and tok.stats.fused_pieces >= 800
    assert tok.stats.host_wave_pieces == tok.stats.fused_pieces + 80
    assert [tok._route_wave_host(n) for n in sizes] == route
    texts = _big_batch(21, 22)
    texts[-1] += _long_runs("streak")
    for g, t in zip(tok.encode_batch(texts), texts):
        assert list(g) == host.encode(t)
    # The wave may also carry words the scan deferred for row capacity.
    assert tok.stats.device_waves == 1 and tok.stats.device_long_pieces == 64


def test_bounded_dedup_reset(vocab):
    """test_tpu_pipeline.py::test_bounded_dedup_reset"""
    tok = _gpu(vocab, max_unique_rows=500)
    host = _host_of(vocab)
    batches = [
        [" ".join(_word(f"{i}:{j}", 5) for j in range(120)) for i in range(6)] for _ in range(4)
    ]
    for texts in batches:
        for g, t in zip(tok.encode_batch(texts), texts):
            assert list(g) == host.encode(t)
    assert tok.stats.dedup_resets >= 1
    assert tok._n_rows <= 500 + 1200

    resets_before = tok.stats.dedup_resets
    flat = [ids for b in tok.encode_batch_stream(iter(batches)) for ids in b]
    want = [host.encode(t) for texts in batches for t in texts]
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        assert list(g) == w
    assert tok.stats.dedup_resets > resets_before

    for t, res in zip(batches[0], tok.encode_trim_suffix_batch(batches[0], 7)):
        assert (res.token_ids, res.text) == tuple(host.encode_trim_suffix(t, 7))
    assert tok.stats.device_pieces > 0


@pytest.mark.parametrize("mesh,fuse", [(None, True), ("auto", True), (None, False)])
def test_generational_dedup_no_sawtooth(vocab, mesh, fuse):
    """test_tpu_pipeline.py::test_generational_dedup_no_sawtooth.  (None, True)
    keeps default routing, so first-seen pieces merge inside the scan as
    there; the JAX "auto" case is the test suite's 8-device CPU mesh, which
    the port's "auto" never builds on the CPU, so it is eight ``cpu`` shards
    here; (None, False) forces every wave onto the merge."""
    if mesh == "auto":
        tok = _gpu(vocab, force=False, mesh=data_mesh(devices=["cpu"] * 8), max_unique_rows=1600)
    else:
        tok = _gpu(vocab, force=not fuse, mesh=None, max_unique_rows=1600)
    if not fuse:
        tok._scan_defer_len = lambda: None
    host = _host_of(vocab)
    hot = [_word(f"hot:{j}") for j in range(300)]
    merges_per_chunk = []
    copies_per_chunk = []
    for ci in range(8):
        fresh = [_word(f"c{ci}:{j}") for j in range(250)]
        text = " ".join(hot + fresh)
        before = tok.stats.as_dict()
        got = tok.encode_batch([text])[0]
        assert list(got) == host.encode(text), f"chunk {ci} parity"
        d = {k: tok.stats.as_dict()[k] - before[k] for k in before}
        copies_per_chunk.append(d["dedup_gen_copies"])
        merges_per_chunk.append(d["unique_pieces"] - d["dedup_gen_copies"])
    assert tok.stats.dedup_resets >= 2, "stream never rotated"
    assert tok.stats.dedup_gen_copies > 0, "old generation never probed"
    assert tok._n_rows <= 800 + 700
    post_rotation = [m for m, c in zip(merges_per_chunk, copies_per_chunk) if c > 0]
    assert post_rotation, "no chunk exercised resurrection"
    for m in post_rotation:
        assert m <= 400, f"cold-chunk sawtooth: {m} re-merges in one chunk"
    assert max(copies_per_chunk) >= 200
    if mesh is None and fuse:
        assert tok.stats.fused_pieces > 0
    else:
        assert tok.stats.device_pieces > 0 and tok.stats.fused_pieces == 0


def test_subset_allowed_special_bulk_paths():
    """test_tpu_pipeline.py::test_subset_allowed_special_bulk_paths"""
    tok = _port("p50k_edit")
    host = _host("p50k_edit")
    sub = ["<|fim_prefix|>", "<|fim_suffix|>"]
    docs = [
        "a<|fim_prefix|>b<|fim_middle|>c<|fim_suffix|>d<|endoftext|>e",
        "<|fim_prefix|><|fim_prefix|>",
        "x<|endoftext|>",
    ]
    want = [host.encode(t, allowed_special=sub) for t in docs]
    for g, w, t in zip(tok.encode_batch(docs, allowed_special=sub), want, docs):
        assert list(g) == w, t
    for t, r in zip(docs, tok.encode_trim_suffix_batch(docs, 3, allowed_special=sub)):
        assert (r.token_ids, r.text) == tuple(host.encode_trim_suffix(t, 3, allowed_special=sub)), t
    for t, r in zip(docs, tok.encode_trim_prefix_batch(docs, 3, allowed_special=sub)):
        assert (r.token_ids, r.text) == tuple(host.encode_trim_prefix(t, 3, allowed_special=sub)), t
    assert tok.stats.device_pieces > 0


def test_megapiece_single_token_run(pair):
    """test_tpu_pipeline.py::test_megapiece_single_token_run"""
    tok, host = pair
    p4 = "a" * 4096
    assert tok.encode(p4) == host.encode(p4)
    big = "a" * (1 << 20)
    ids = tok.encode_batch([big])[0]
    assert tok.decode_batch([np.asarray(ids)])[0] == big
    assert list(ids) == list(tok.encode_batch([big])[0])


def test_overlapping_custom_specials_insertion_order():
    """test_tpu_pipeline.py::test_overlapping_custom_specials_insertion_order"""
    docs = ["<|a|>b", "x<|a|>bz", "<|a|><|a|>b", "pre<|a|>"]
    for extras in (
        {"<|a|>": 50258, "<|a|>b": 50259},
        {"<|a|>b": 50259, "<|a|>": 50258},
    ):
        host = _host(extra_special_tokens=extras)
        tok = _port(extra_special_tokens=extras)
        for t in docs:
            w = host.encode(t, allowed_special="all")
            assert tok.encode(t, allowed_special="all") == w, (extras, t)
            assert list(tok.encode_batch([t], allowed_special="all")[0]) == w, (extras, t)
    a = _host(extra_special_tokens={"<|a|>": 50258, "<|a|>b": 50259})
    b = _host(extra_special_tokens={"<|a|>b": 50259, "<|a|>": 50258})
    assert a.encode("<|a|>b", allowed_special="all") == [50258, 65]
    assert b.encode("<|a|>b", allowed_special="all") == [50259]


def test_bulk_apis_reject_bare_string(pair):
    """test_tpu_pipeline.py::test_bulk_apis_reject_bare_string"""
    tok, _ = pair
    with pytest.raises(TypeError, match="sequence of texts"):
        tok.encode_batch("hello")
    with pytest.raises(TypeError, match="sequence of texts"):
        tok.encode_trim_suffix_batch("hello", 3)
    with pytest.raises(TypeError, match="sequence of texts"):
        tok.encode_trim_prefix_batch("hello", 3)
    with pytest.raises(TypeError, match="sequence of texts"):
        list(tok.encode_batch_stream(iter(["hello"])))


def test_concurrent_public_api_threads():
    """test_tpu_pipeline.py::test_concurrent_public_api_threads"""
    tok = _port(max_unique_rows=600, mesh=None)
    host = _host()

    def work(seed):
        rng = random.Random(seed)
        for _ in range(6):
            docs = [
                " ".join("t%d_%d" % (seed, rng.randrange(3000)) for _ in range(rng.randint(5, 60)))
                for _ in range(rng.randint(1, 12))
            ]
            got = tok.encode_batch(docs)
            for t, ids in zip(docs, got):
                assert list(ids) == host.encode(t), t[:50]
            assert tok.decode_batch(got) == docs
            for t, res in zip(docs, tok.encode_trim_suffix_batch(docs, 5)):
                assert (res.token_ids, res.text) == tuple(host.encode_trim_suffix(t, 5))
        return True

    with ThreadPoolExecutor(max_workers=8) as ex:
        assert all(ex.map(work, range(8)))
    assert tok.stats.device_pieces > 0


def test_stream_interleaved_with_bulk_calls():
    """test_tpu_pipeline.py::test_stream_interleaved_with_bulk_calls"""
    tok = _port(max_unique_rows=600, mesh=None)
    host = _host()
    batches = [
        ["s%d_%d unique piece soup %d" % (b, i, i * 7) for i in range(40)] for b in range(6)
    ]
    side_docs = ["side %d words %d here" % (k, k * 13) for k in range(300)]
    out = []
    for k, got in enumerate(tok.encode_batch_stream(iter(batches))):
        out.append(got)
        assert tok._stream_inflight <= 1
        side = side_docs[k * 50 : (k + 1) * 50]
        for t, ids in zip(side, tok.encode_batch(side)):
            assert list(ids) == host.encode(t)
    assert len(out) == len(batches)
    for batch, got in zip(batches, out):
        for t, ids in zip(batch, got):
            assert list(ids) == host.encode(t), t
    assert tok._stream_inflight == 0


def test_stream_abandoned_with_deferred_chunk():
    """test_tpu_pipeline.py::test_stream_abandoned_with_deferred_chunk"""
    tok = _port(max_unique_rows=600, mesh=None)
    host = _host()
    batches = [["ab%d cd%d" % (b * 100 + i, i) for i in range(30)] for b in range(5)]
    gen = tok.encode_batch_stream(iter(batches))
    first = next(gen)
    for t, ids in zip(batches[0], first):
        assert list(ids) == host.encode(t)
    assert tok._stream_inflight == 1  # batch 1 is deferred on the merge
    gen.close()
    assert tok._stream_inflight == 0
    docs = ["post abandon %d" % i for i in range(40)]
    for t, ids in zip(docs, tok.encode_batch(docs)):
        assert list(ids) == host.encode(t)


def test_decode_batch_unknown_ids_and_empty(pair):
    """test_tpu_pipeline.py::test_decode_batch_unknown_ids_and_empty"""
    tok, host = pair
    batches = [
        list(range(200)),
        [],
        [10, -5, 99999999, 20] * 80,
        host.encode("étoile ⭐ 你好") * 40,
    ]
    assert tok.decode_batch(batches) == [host.decode(ids) for ids in batches]
    big = [3, 4, 5, -1, 2**31 - 1] * 30
    assert tok.decode(big) == host.decode(big)


def test_trim_vec_mixed_overflow_rows(pair):
    """test_tpu_pipeline.py::test_trim_vec_mixed_overflow_rows"""
    tok, host = pair
    docs = [
        "plain words " * 40,
        "mid " + "好" * 200 + " tail words " * 30,
        "lead words " * 30 + "好" * 200,
        "",
        "short",
    ]
    for t in docs:
        host.encode(t)  # warm the host LRU (trim text is cache-dependent)
    for budget in (3, 17, 64):
        for mode in ("ts", "cs"):
            got = tok.encode_trim_suffix_batch(docs, budget, mode=mode)
            for t, r in zip(docs, got):
                want = host.encode_trim_suffix(t, budget, mode=mode)
                assert (r.token_ids, r.text) == tuple(want), (t[:30], budget, mode)
        for t, r in zip(docs, tok.encode_trim_prefix_batch(docs, budget)):
            want = host.encode_trim_prefix(t, budget)
            assert (r.token_ids, r.text) == tuple(want), (t[:30], budget)


def test_trim_prefix_vec_overshoot_batched(pair):
    """test_tpu_pipeline.py::test_trim_prefix_vec_overshoot_batched"""
    tok, host = pair
    docs = ["word%d " % i + "filler words here " * 50 for i in range(20)]
    for t in docs:
        host.encode(t)
    for t, r in zip(docs, tok.encode_trim_prefix_batch(docs, 5)):
        assert (r.token_ids, r.text) == tuple(host.encode_trim_prefix(t, 5))


def test_data_mesh_raises_on_too_few_devices():
    """test_tpu_pipeline.py::test_data_mesh_raises_on_too_few_devices"""
    n = len(local_devices())
    with pytest.raises(ValueError, match="device"):
        data_mesh(n + 1)
    with pytest.raises(ValueError, match="device"):
        data_mesh(9, devices=["cpu"] * 8)
    assert data_mesh(8, devices=["cpu"] * 8).size == 8


_SIDE = "zqxw kvjp again 123"
_SIDE_CALLS = {
    "encode_batch": lambda tok, host: (
        [list(ids) for ids in tok.encode_batch([_SIDE])] == [host.encode(_SIDE)]
    ),
    "encode_trim_suffix_batch": lambda tok, host: (
        [tuple(r) for r in tok.encode_trim_suffix_batch([_SIDE], 3)]
        == [tuple(host.encode_trim_suffix(_SIDE, 3))]
    ),
    "encode_trim_prefix_batch": lambda tok, host: (
        [tuple(r) for r in tok.encode_trim_prefix_batch([_SIDE], 3)]
        == [tuple(host.encode_trim_prefix(_SIDE, 3))]
    ),
    "encode": lambda tok, host: tok.encode(_SIDE * 80) == host.encode(_SIDE * 80),
    "encode_batch_stream": lambda tok, host: (
        [list(ids) for b in tok.encode_batch_stream([[_SIDE]]) for ids in b]
        == [host.encode(_SIDE)]
    ),
}


@pytest.mark.parametrize("call", list(_SIDE_CALLS))
def test_bulk_call_between_stream_chunks_meets_the_deferred_chunk_s_pieces(call):
    """No JAX counterpart (the JAX package fails here the same way).  A bulk
    call between the yields of a stream whose next chunk is deferred on the
    merge, on pieces first seen in that chunk: they are interned but their
    rows publish only when the chunk's wave resolves, so the call used to
    raise (unresolved uid in the backfill, or -7 from the assembler).  The
    call now resolves the stream's deferred chunk first; both it and the
    stream give the host engine's ids."""
    tok = _port("cl100k_synth")
    host = _host("cl100k_synth")
    batches = [["alpha beta gamma"], ["zqxw kvjp 123"], ["tail"]]
    gen = tok.encode_batch_stream(iter(batches))
    assert [list(ids) for ids in next(gen)] == [host.encode(batches[0][0])]
    assert tok._stream_inflight == 1
    assert _SIDE_CALLS[call](tok, host)
    rest = [list(ids) for b in gen for ids in b]
    assert rest == [host.encode(b[0]) for b in batches[1:]]
    assert tok._stream_inflight == 0 and not tok._stream_drains
