"""The one-pass scan+merge+emit route of GpuTokenizer vs the host engine.

The counterpart of ``tests/test_emit_path.py``, case for case: each
test's docstring names its JAX test.  ``device="cpu"`` with every wave
forced onto the plain PyTorch merge (``_host_pp = inf``,
``_host_wave_max = 0``), so first-seen pieces come back as holes that a
device wave fills, unless the JAX test asserts a routing decision.  The
stream router tests keep default routing and steer the router by what
it reads, the pieces' lengths and their number: where the JAX tests
make the device cheap, the port's chunk carries 64 first-seen pieces
longer than ``gpu.L_HOST`` (:func:`_device_leaning`), which leave the
fused scan for one wave, larger than ``gpu.HOST_WAVE_MAX``, that goes
to the merge.  Ids must equal the port's host ``TikTokenizer`` exactly.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from conftest import require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

from tokenizer_tpu_torch.engine import TikTokenizer
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.models.registry import get_encoding_spec
from tokenizer_tpu_torch.vocab import Vocabulary


@pytest.fixture(scope="module")
def vocab():
    require_vocab("gpt2")
    return Vocabulary.for_encoding("gpt2", allow_fetch=False)


def _gpu(vocab, force=True, **kw):
    spec = get_encoding_spec("gpt2")
    tok = GpuTokenizer(vocab, spec.special_tokens, spec.pattern, device="cpu", mesh=None, **kw)
    return forced(tok) if force else tok


def _host(vocab):
    spec = get_encoding_spec("gpt2")
    return TikTokenizer(vocab, spec.special_tokens, spec.pattern)


@pytest.fixture()
def toks(vocab):
    return _gpu(vocab), _host(vocab)


def _device_leaning(tag, n: int = 64) -> str:
    """What makes the port's router choose the device where the JAX tests
    set a device-favouring state: ``n`` first-seen letter runs of 700
    bytes, each one piece longer than ``gpu.L_HOST`` (so the scan leaves it
    to the chunk's wave); more than ``gpu.HOST_WAVE_MAX`` of them send the
    wave to the merge.  ``_device_leaning(tag, k)`` repeats the first ``k``
    runs of ``_device_leaning(tag)``."""
    runs = []
    for j in range(n):
        h = hashlib.blake2b(f"{tag}:{j}".encode(), digest_size=64).digest() * 11
        runs.append("".join(chr(97 + b % 26) for b in h[:700]))
    return " " + " ".join(runs)


def _chained(tok) -> list:
    """Watch ``tok``'s stream: for each chunk scanned while an earlier
    chunk's wave was still in flight whose scan came back deferred with
    holes and no wave of its own (``must_defer`` chaining: the holes
    reference the pending wave's uids), its hole count."""
    chained = []
    emit = tok._native_encode_emit

    def spy(*args, **kw):
        out = emit(*args, **kw)
        if kw.get("must_defer") and isinstance(out, tuple) and out[0] == "emit_deferred" \
                and out[-1] is None:
            chained.append(len(out[5][0]))
        return out

    tok._native_encode_emit = spy
    return chained


def _word(tag, j):
    h = hashlib.blake2b(f"{tag}:{j}".encode(), digest_size=6).digest()
    return "".join(chr(97 + b % 26) for b in h)


def test_emit_route_taken_and_exact(vocab):
    """test_emit_path.py::test_emit_route_taken_and_exact (default routing)"""
    tok, host = _gpu(vocab, force=False), _host(vocab)
    texts = [
        "Hello World, the emit path encodes in one pass.",
        "",
        "unicode ⭐ étoile 你好 💩 12345 'll 'VE",
        " ".join(_word("a", j) for j in range(300)),
        "trailing spaces   \n\n mixed \r\n",
    ]
    for g, t in zip(tok.encode_batch(texts), texts):
        assert list(g) == host.encode(t), t[:40]
    assert tok.stats.fused_pieces > 0


def test_emit_specials_interleaved(toks):
    """test_emit_path.py::test_emit_specials_interleaved"""
    tok, host = toks
    texts = [
        "x<|endoftext|>y<|endoftext|>z tail",
        "<|endoftext|>",
        "<|endoftext|>lead",
        "no specials here",
        "tail<|endoftext|>",
    ]
    for g, t in zip(tok.encode_batch(texts, allowed_special="all"), texts):
        assert list(g) == host.encode(t, allowed_special="all"), t
    assert tok.stats.device_pieces > 0


def test_emit_overflow_rows(toks):
    """test_emit_path.py::test_emit_overflow_rows"""
    tok, host = toks
    big = "好" * 400
    texts = [f"before {big} after", big]
    for _ in range(2):  # the second time from the overflow pool
        for g, t in zip(tok.encode_batch(texts), texts):
            assert list(g) == host.encode(t)


@pytest.mark.parametrize("force", [True, False])
def test_emit_holes_via_capacity_pressure(vocab, monkeypatch, force):
    """test_emit_path.py::test_emit_holes_via_capacity_pressure.  Forced, every
    first-seen piece is a hole that the device wave fills; unforced, as in the
    JAX test, the fused scan defers once its rows run out."""
    tok, host = _gpu(vocab, force=force), _host(vocab)
    monkeypatch.setattr(tok, "_prepare_fused_capacity", lambda nbytes: None)
    texts = [" ".join(_word(f"h{k}", j) for j in range(400)) for k in range(6)]
    for g, t in zip(tok.encode_batch(texts), texts):
        assert list(g) == host.encode(t), "hole backfill parity"
    assert (tok.stats.device_pieces > 0) == force


def test_emit_patch_overflow_falls_back(toks, monkeypatch):
    """test_emit_path.py::test_emit_patch_overflow_falls_back"""
    tok, host = toks
    ctx_cls = type(tok._native.SplitContext(1))
    monkeypatch.setattr(ctx_cls, "_PATCH_CAP", 1)
    monkeypatch.setattr(tok, "_prepare_fused_capacity", lambda n: None)
    texts = [" ".join(_word(f"p{k}", j) for j in range(300)) for k in range(4)]
    for _ in range(2):  # then the steady retry: every uid has its row
        for g, t in zip(tok.encode_batch(texts), texts):
            assert list(g) == host.encode(t)
    assert tok.stats.device_pieces > 0


def test_emit_with_generational_rotation(toks):
    """test_emit_path.py::test_emit_with_generational_rotation"""
    tok, host = toks
    tok._max_unique_rows = 1200
    hot = [_word("hot", j) for j in range(250)]
    for ci in range(6):
        fresh = [_word(f"r{ci}", j) for j in range(200)]
        text = " ".join(hot + fresh)
        assert list(tok.encode_batch([text])[0]) == host.encode(text), f"chunk {ci}"
    assert tok.stats.dedup_resets >= 1
    assert tok.stats.dedup_gen_copies > 0


def test_emit_stream_matches_classic(toks):
    """test_emit_path.py::test_emit_stream_matches_classic"""
    tok, host = toks
    rng = np.random.default_rng(5)
    alphabet = "abc ABC 123 \n\r\t ⭐你好 é 💩 '! .,<|endoftext|>"
    batches = [
        [
            "".join(alphabet[rng.integers(0, len(alphabet))] for _ in range(rng.integers(0, 120)))
            for _ in range(40)
        ]
        for _ in range(4)
    ]
    flat = [
        ids for b in tok.encode_batch_stream(iter(batches), allowed_special="all") for ids in b
    ]
    want = [host.encode(t, allowed_special="all") for b in batches for t in b]
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        assert list(g) == w


def test_emit_outputs_own_their_storage(toks):
    """test_emit_path.py::test_emit_outputs_own_their_storage"""
    tok, host = toks
    text = "ring ownership check ⭐ 123"
    first = tok.encode_batch([text])[0]
    want = list(first)
    for k in range(10):
        tok.encode_batch([f"filler {k} " * 50])
    assert list(first) == want == host.encode(text)


def test_emit_thread_storm(vocab, monkeypatch):
    """test_emit_path.py::test_emit_thread_storm"""
    monkeypatch.setenv("TOKENIZER_TPU_THREADS", "8")
    monkeypatch.setenv("TOKENIZER_TPU_SUBSEG_BYTES", "4096")
    host = _host(vocab)
    big = " ".join(_word("s", j) for j in range(40000))
    want = host.encode(big)
    for trial in range(2):
        tok = _gpu(vocab, max_unique_rows=30000)
        assert list(tok.encode_batch([big])[0]) == want, f"trial {trial}"
        assert list(tok.encode_batch([big])[0]) == want, f"trial {trial} steady"
        assert tok.stats.dedup_resets >= 1 and tok.stats.device_pieces > 0


def test_emit_device_route_no_fuse(toks):
    """test_emit_path.py::test_emit_device_route_no_fuse"""
    tok, host = toks
    tok._scan_defer_len = lambda: None
    for ci in range(4):
        texts = [" ".join(_word(f"d{ci}:{k}", j) for j in range(150)) for k in range(4)]
        for g, t in zip(tok.encode_batch(texts), texts):
            assert list(g) == host.encode(t), (ci, t[:40])
    texts0 = [" ".join(_word(f"d0:{k}", j) for j in range(150)) for k in range(4)]
    for g, t in zip(tok.encode_batch(texts0), texts0):
        assert list(g) == host.encode(t)
    assert tok.stats.fused_pieces == 0


def test_stream_router_flip_dev_to_emit(vocab):
    """test_emit_path.py::test_stream_router_flip_dev_to_emit"""
    tok, host = _gpu(vocab, force=False), _host(vocab)
    chained = _chained(tok)
    # A device wave, deferred: the long runs; the words fuse.
    big = [" ".join(_word("flip", j) for j in range(1500)) + _device_leaning("flip")]
    # Repeats chunk 1's words and 8 of its long runs (holes on the
    # in-flight wave), with a couple of new words that fuse: emit.
    rep = [" ".join(_word("flip", j) for j in range(40)) + _device_leaning("flip", 8)
           + " fresh bits"]
    got = [ids for b in tok.encode_batch_stream(iter([big, rep])) for ids in b]
    assert list(got[0]) == host.encode(big[0])
    assert list(got[1]) == host.encode(rep[0])
    assert tok.stats.device_pieces > 0, "chunk 1 never took the device"
    assert tok.stats.fused_pieces > 0, "chunk 2 never took the host"
    assert len(chained) == 1 and chained[0] >= 8, f"chunk 2's holes on chunk 1's wave: {chained}"


def test_stream_alternating_routes_chain(vocab):
    """test_emit_path.py::test_stream_alternating_routes_chain"""
    tok, host = _gpu(vocab, force=False), _host(vocab)
    chained = _chained(tok)
    batches = []
    for r in range(3):
        batches.append([" ".join(_word(f"r{r}", j) for j in range(1400)) + _device_leaning(f"r{r}")])
        # Holes on the previous chunk's in-flight wave: 8 of its long runs.
        batches.append([" ".join(_word(f"r{r}", j) for j in range(30)) + _device_leaning(f"r{r}", 8)
                        + " tail bit"])
    got = [ids for b in tok.encode_batch_stream(iter(batches)) for ids in b]
    for i, (g, b) in enumerate(zip(got, batches)):
        assert list(g) == host.encode(b[0]), f"chunk {i}"
    assert tok.stats.device_waves >= 3
    assert len(chained) == 3 and min(chained) >= 8, f"holes on in-flight waves: {chained}"


def test_stream_patch_overflow_with_deferred_wave(vocab, monkeypatch):
    """test_emit_path.py::test_stream_patch_overflow_with_deferred_wave.  The
    first chunk's 64 long runs are its holes (under the cap) and its wave
    is deferred; the second repeats them twice while that wave is in
    flight: 128 holes overflow the cap."""
    tok, host = _gpu(vocab, force=False), _host(vocab)
    ctx_cls = type(tok._native.SplitContext(1))
    monkeypatch.setattr(ctx_cls, "_PATCH_CAP", 100)
    big = [" ".join(_word("ov", j) for j in range(1500)) + _device_leaning("ov")]
    rep = [" ".join(_word("ov", j) for j in range(200)) + _device_leaning("ov") * 2]
    got = [ids for b in tok.encode_batch_stream(iter([big, rep])) for ids in b]
    assert list(got[0]) == host.encode(big[0])
    assert list(got[1]) == host.encode(rep[0])
    assert tok.stats.device_pieces > 0
