"""A device wave's long pieces: on the merge up to MAX_L, on the host above.

The port's device buckets (``gpu.DEVICE_BUCKETS``) are the packer's
16..512 followed by 1024 and the merge kernel's ``MAX_L`` (2,048): a
device wave's pieces of 513-2,048 bytes merge in ``[1024, B]`` and
``[2048, B]`` tiles like any other.  Pieces longer than the widest bucket
never reach the merge: ``GpuTokenizer._finish_span_rows`` resolves all of
one wave's such pieces in a single ``bpe_encode_batch_spans`` call, with
the whole-piece encoder hit first, and spills the rows of more than 128
ids to the overflow pool.  ``device="cpu"`` runs the port's device
plumbing with every wave forced onto the plain PyTorch merge.  The
references are the JAX ``TpuTokenizer`` on the test suite's 8-device CPU
mesh (every wave a device wave, its widest bucket 512, each longer piece
through its per-piece ``_oracle_piece``) and Rust ``tiktoken`` built from
the same ranks (``tools/synth_goldens.py``).  Ids must be equal, exactly.
"""

from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

tiktoken = pytest.importorskip("tiktoken")

from conftest import require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu import create_by_encoder_name as create_jax
from tokenizer_tpu_torch import gpu
from tokenizer_tpu_torch.ops.merge_cuda import MAX_L
from tokenizer_tpu_torch.ops.packing import BUCKETS
from tokenizer_tpu_torch.parallel import data_mesh

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import synth_goldens  # noqa: E402

NAME = "cl100k_synth"
WIDEST = gpu.DEVICE_BUCKETS[-1]
#: cases whose host-merged pieces must fit in a row.  No piece over
#: MAX_L does under cl100k_synth (a run of 2,100 spaces merges to 262
#: ids, a 12-letter word repeated to 2,100 bytes to 176, a row holds
#: 128), so these run with the device buckets narrowed to the packer's
#: 512, which puts their 700- and 911-space runs on the host path.
NARROW = ("no_spill", "mixed")


def _cjk(rng, n: int) -> str:
    """A run of ``n`` CJK ideographs: one piece of 3n bytes that merges
    to many ids (it spills past a row's 128)."""
    return "".join(map(chr, rng.integers(0x4E00, 0x9FA5, size=n)))


def _words(rng, n: int) -> str:
    alpha = "abcdefghijklmnopqrstuvwxyz"
    return " ".join(
        "".join(alpha[j] for j in rng.integers(0, 26, size=int(rng.integers(1, 9))))
        for _ in range(n)
    )


def _plain(rng, n: int = 6) -> list:
    return [f"doc {i}: {_words(rng, 30)} {int(rng.integers(1e9))}" for i in range(n)]


def _docs(case: str) -> list:
    """The case's batch, from a seed: ordinary documents, with pieces over
    the widest bucket that spill (a CJK run of 700 ideographs, 2,100 bytes,
    and a run of 2,100 spaces), pieces that do not (runs of 700 and 911
    spaces, a few ids, over the narrowed 512), or none."""
    rng = np.random.default_rng(10)
    plain = _plain(rng)
    spill = [_cjk(rng, 700) for _ in range(2)] + [" " * 2100]
    short_spill = [_cjk(rng, 250) for _ in range(3)]  # 750 bytes
    blank = [" " * 700, " " * 911]
    if case == "none":
        return plain
    if case == "spill":
        return [f"{p} {s} tail" for p, s in zip(plain, spill + spill)]
    if case == "no_spill":
        return [f"{p}{b}x" for p, b in zip(plain, blank * 3)]
    assert case == "mixed"
    return [
        f"{plain[0]} {short_spill[0]} and{blank[0]}x",
        plain[1],
        f"{short_spill[1]}\n{plain[2]}{blank[1]}y {short_spill[0]}",
        f"{plain[3]} {short_spill[2]}",
        "",
        f"{blank[0]}z {plain[4]}",
    ]


_REFS: dict = {}


def _refs(name: str):
    """(Rust tiktoken, JAX TpuTokenizer on the 8-device CPU mesh), once a
    vocabulary."""
    if name not in _REFS:
        require_vocab(name)
        jax_tok = create_jax(name, allow_fetch=False, use_tpu=True)
        jax_tok._ensure_device()  # resolve the mesh now so its waves shard
        assert jax_tok.mesh is not None
        _REFS[name] = (synth_goldens.rust_encoding(name), jax_tok)
    return _REFS[name]


_PORTS: dict = {}


def _port(name: str):
    """The port's tokenizer of ``name`` on the CPU, every wave forced onto
    the merge, its dedup state emptied; one a vocabulary."""
    if name not in _PORTS:
        require_vocab(name)
        _PORTS[name] = forced(tt.create_by_encoder_name(name, allow_fetch=False, device="cpu"))
    _PORTS[name]._reset_dedup_full()
    return _PORTS[name]


def _jax_matches(jax_tok, docs, want) -> int:
    """The JAX package's ids equal tiktoken's; returns its host fallbacks."""
    jax_tok._reset_dedup_full()
    fb0 = jax_tok.stats.host_fallback_pieces
    for d, w, j in zip(docs, want, jax_tok.encode_batch(docs)):
        assert list(j) == w, repr(d[:60])
    return jax_tok.stats.host_fallback_pieces - fb0


def _watch(tok, monkeypatch):
    """Count the batched native merge's pieces per call and the merge's
    tiles per L; make the per-piece oracle raise."""
    calls, tiles = [], Counter()
    real = tok._native.bpe_encode_batch_spans

    def counting(buf, starts, ends, table, **kw):
        calls.append(len(starts))
        return real(buf, starts, ends, table, **kw)

    def no_oracle(pbytes):
        raise AssertionError("a device wave's piece took the per-piece oracle")

    tok._ensure_device()
    merge = tok._merge_fn

    def counting_merge(tab, ids, lengths):
        tiles[int(ids.shape[0])] += 1
        return merge(tab, ids, lengths)

    monkeypatch.setattr(tok._native, "bpe_encode_batch_spans", counting)
    monkeypatch.setattr(tok, "_oracle_piece", no_oracle)
    monkeypatch.setattr(tok, "_merge_fn", counting_merge)
    return calls, tiles


def _run(tok, docs, entry):
    if entry == "batch":
        return tok.encode_batch(docs)
    chunks = [docs[i : i + 2] for i in range(0, len(docs), 2)]
    return [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]


@pytest.mark.parametrize("entry", ["batch", "stream"])
@pytest.mark.parametrize("case", ["spill", "no_spill", "mixed", "none"])
def test_oversized_pieces_one_native_call_per_wave(case, entry, monkeypatch):
    rust, jax_tok = _refs(NAME)
    widest = WIDEST
    if case in NARROW:
        monkeypatch.setattr(gpu, "DEVICE_BUCKETS", BUCKETS)
        widest = BUCKETS[-1]
    tok = _port(NAME)
    docs = _docs(case)
    want = [rust.encode_ordinary(d) for d in docs]
    jax_fb = _jax_matches(jax_tok, docs, want)

    oversized = {
        p for d in docs for p in tok._re.findall(d) if len(p.encode("utf-8")) > widest
    }
    # The inputs hold what the case names: every oversized piece of
    # "spill" merges to over 128 ids, none of "no_spill" does.
    n_ids = [len(rust.encode_ordinary(p)) for p in oversized]
    assert (case == "none") == (not oversized)
    if case == "spill":
        assert min(n_ids) > 128
    elif case == "no_spill":
        assert max(n_ids) <= 128
    elif case == "mixed":
        assert min(n_ids) <= 128 < max(n_ids)
    # Every piece over 512 bytes is oversized for the JAX package.
    assert jax_fb == len(oversized)

    calls, _tiles = _watch(tok, monkeypatch)
    fb0, waves0 = tok.stats.host_fallback_pieces, tok.stats.device_waves
    host0 = tok.stats.host_wave_pieces
    got = _run(tok, docs, entry)
    assert len(got) == len(docs)
    for d, g, w in zip(docs, got, want):
        assert list(g) == w, repr(d[:60])
    waves = tok.stats.device_waves - waves0
    assert waves > 0 and tok.stats.host_wave_pieces == host0
    assert tok.stats.host_fallback_pieces - fb0 == len(oversized)
    # One native call for each wave that holds oversized pieces, none
    # for a wave without.
    assert sum(calls) == len(oversized)
    assert len(calls) <= waves and all(n > 0 for n in calls)
    if case == "none":
        assert calls == []


def _long(rng, kind: str, lo: int, hi: int) -> str:
    """A run that the case's pattern keeps as one piece of lo < len <= hi
    bytes wherever it stands: CJK ideographs (with a space before them
    where there is one), spaces (the run before a word, less its last
    space where nothing precedes it), ASCII letters or digits (gpt2's
    `` ?\\p{N}+``), each with a space before them."""
    n = int(rng.integers(lo + 2, hi + 1))
    if kind == "cjk":
        return _cjk(rng, n // 3)
    if kind == "spaces":
        return " " * n + "x"
    alpha = "0123456789" if kind == "digits" else "abcdefghijklmnopqrstuvwxyz"
    return " " + "".join(alpha[j] for j in rng.integers(0, len(alpha), size=n - 1))


#: (vocabulary, kind of run): digits make one long piece under gpt2's
#: pattern only (cl100k's splits them in threes).
KINDS = [(NAME, "cjk"), (NAME, "spaces"), (NAME, "identifier"), ("gpt2", "digits")]
BANDS = [(BUCKETS[-1], 1024), (1024, MAX_L)]


@pytest.mark.parametrize("entry", ["batch", "stream"])
@pytest.mark.parametrize("band", BANDS, ids=lambda b: f"{b[0] + 1}-{b[1]}")
@pytest.mark.parametrize("name,kind", KINDS, ids=lambda x: x)
def test_long_pieces_merge_on_the_device(name, kind, band, entry, monkeypatch):
    """Pieces of 513-1,024 and 1,025-2,048 bytes take the merge, in tiles
    of L = 1024 and 2048: no host fallback, no native merge call, one tile
    of their L a wave that holds them, ids equal to the JAX package's and
    tiktoken's."""
    rust, jax_tok = _refs(name)
    tok = _port(name)
    lo, hi = band
    rng = np.random.default_rng(hi + len(kind))
    plain = _plain(rng, 4)
    docs = [f"{plain[0]} {_long(rng, kind, lo, hi)} tail", plain[1],
            f"{_long(rng, kind, lo, hi)} {plain[2]}", f"{plain[3]}{_long(rng, kind, lo, hi)}"]
    want = [rust.encode_ordinary(d) for d in docs]
    # The JAX package merges them on its host, one by one.
    n_long = _jax_matches(jax_tok, docs, want)

    pieces = {p.encode("utf-8") for d in docs for p in tok._re.findall(d)}
    long = {p for p in pieces if len(p) > BUCKETS[-1]}
    assert len(long) >= 2 and all(lo < len(p) <= hi for p in long)
    assert n_long == len(long)

    calls, tiles = _watch(tok, monkeypatch)
    fb0, dl0 = tok.stats.host_fallback_pieces, tok.stats.device_long_pieces
    waves0 = tok.stats.device_waves
    got = _run(tok, docs, entry)
    for d, g, w in zip(docs, got, want):
        assert list(g) == w, repr(d[:60])
    assert tok.stats.host_fallback_pieces == fb0 and calls == []
    assert tok.stats.device_long_pieces - dl0 == len(long)
    waves = tok.stats.device_waves - waves0
    holding = 1 if entry == "batch" else sum(
        any(len(p.encode("utf-8")) > BUCKETS[-1] for d in docs[i : i + 2] for p in tok._re.findall(d))
        for i in range(0, len(docs), 2)
    )
    assert 0 < holding <= waves
    assert tiles[hi] == holding
    assert all(tiles[L] == 0 for L in gpu.DEVICE_BUCKETS if L > BUCKETS[-1] and L != hi)


def test_long_pieces_on_a_mesh(monkeypatch):
    """A mesh of eight CPU shards: one wave holds pieces for both long
    buckets and pieces over MAX_L.  Each long tile's columns split over
    the shards (one merge call a shard), the pieces over MAX_L take the
    one native call, and the ids equal the JAX package's and tiktoken's."""
    rust, jax_tok = _refs(NAME)
    tok = tt.create_by_encoder_name(
        NAME, allow_fetch=False, device="cpu", mesh=data_mesh(devices=["cpu"] * 8)
    )
    rng = np.random.default_rng(16)
    plain = _plain(rng, 5)
    docs = [
        f"{plain[0]} {_cjk(rng, 250)} and {_long(rng, 'spaces', 1024, 2048)}",
        f"{_cjk(rng, 600)}, {plain[1]}",
        f"{plain[2]} {_cjk(rng, 700)}",
        f"{plain[3]}{_long(rng, 'identifier', 512, 1024)} {plain[4]}",
        " " * 2100 + "z",
    ]
    want = [rust.encode_ordinary(d) for d in docs]
    n_jax = _jax_matches(jax_tok, docs, want)

    lens = [len(p) for p in {p.encode("utf-8") for d in docs for p in tok._re.findall(d)}]
    over = sum(n > MAX_L for n in lens)
    on_card = [n for n in lens if BUCKETS[-1] < n <= MAX_L]
    assert over == 2 and n_jax == over + len(on_card)
    assert {1024, 2048} == {L for L in gpu.DEVICE_BUCKETS if any(
        L // 2 < n <= L for n in on_card)}

    calls, tiles = _watch(tok, monkeypatch)
    got = tok.encode_batch(docs)
    for d, g, w in zip(docs, got, want):
        assert list(g) == w, repr(d[:60])
    assert tok.stats.device_long_pieces == len(on_card)
    assert tok.stats.host_fallback_pieces == over and calls == [over]
    assert tiles[1024] == tiles[2048] == tok.mesh.size
