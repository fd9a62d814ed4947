"""A device wave's oversized pieces, resolved in one batched native merge.

Pieces longer than the widest merge bucket (512 bytes) never reach the
merge kernel: ``GpuTokenizer._finish_span_rows`` resolves all of one
wave's such pieces in a single ``bpe_encode_batch_spans`` call, with the
whole-piece encoder hit first, and spills the rows of more than 128 ids
to the overflow pool.  ``device="cpu"`` runs the port's device plumbing
with every wave forced onto the plain PyTorch merge.  The references are
the JAX ``TpuTokenizer`` on the test suite's 8-device CPU mesh (every
wave a device wave, each oversized piece through its per-piece
``_oracle_piece``) and Rust ``tiktoken`` built from the same ranks
(``tools/synth_goldens.py``).  Ids must be equal, exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

tiktoken = pytest.importorskip("tiktoken")

from conftest import require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu import create_by_encoder_name as create_jax
from tokenizer_tpu_torch.ops.packing import BUCKETS

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import synth_goldens  # noqa: E402

NAME = "cl100k_synth"
WIDEST = BUCKETS[-1]


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


def _docs(case: str) -> list:
    """The case's batch, from a seed: ordinary documents, with oversized
    pieces that spill (a CJK run of 250 ideographs, 750 bytes), oversized
    pieces that do not (a run of 700 spaces, a few ids), or none."""
    rng = np.random.default_rng(10)
    plain = [f"doc {i}: {_words(rng, 30)} {int(rng.integers(1e9))}" for i in range(6)]
    spill = [_cjk(rng, 250) for _ in range(3)]
    blank = [" " * 700, " " * 911]
    if case == "none":
        return plain
    if case == "spill":
        return [f"{p} {s} tail" for p, s in zip(plain, spill + spill)]
    if case == "no_spill":
        return [f"{p}{b}x" for p, b in zip(plain, blank * 3)]
    assert case == "mixed"
    return [
        f"{plain[0]} {spill[0]} and{blank[0]}x",
        plain[1],
        f"{spill[1]}\n{plain[2]}{blank[1]}y {spill[0]}",
        f"{plain[3]} {spill[2]}",
        "",
        f"{blank[0]}z {plain[4]}",
    ]


@pytest.fixture(scope="module")
def refs():
    """(Rust tiktoken, JAX TpuTokenizer on the 8-device CPU mesh)."""
    require_vocab(NAME)
    jax_tok = create_jax(NAME, allow_fetch=False, use_tpu=True)
    jax_tok._ensure_device()  # resolve the mesh now so its waves shard
    assert jax_tok.mesh is not None
    return synth_goldens.rust_encoding(NAME), jax_tok


@pytest.fixture(scope="module")
def port():
    require_vocab(NAME)
    return tt.create_by_encoder_name(NAME, allow_fetch=False, device="cpu")


@pytest.mark.parametrize("entry", ["batch", "stream"])
@pytest.mark.parametrize("case", ["spill", "no_spill", "mixed", "none"])
def test_oversized_pieces_one_native_call_per_wave(case, entry, refs, port, monkeypatch):
    rust, jax_tok = refs
    tok = forced(port)
    tok._reset_dedup_full()
    docs = _docs(case)
    want = [rust.encode_ordinary(d) for d in docs]
    jax_tok._reset_dedup_full()
    jax_fb = jax_tok.stats.host_fallback_pieces
    for d, w, j in zip(docs, want, jax_tok.encode_batch(docs)):
        assert list(j) == w, repr(d[:60])

    oversized = {
        p for d in docs for p in tok._re.findall(d) if len(p.encode("utf-8")) > WIDEST
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
    assert jax_tok.stats.host_fallback_pieces - jax_fb == len(oversized)

    calls = []
    real = tok._native.bpe_encode_batch_spans

    def counting(buf, starts, ends, table, **kw):
        calls.append(len(starts))
        return real(buf, starts, ends, table, **kw)

    def no_oracle(pbytes):
        raise AssertionError("a device wave's piece took the per-piece oracle")

    monkeypatch.setattr(tok._native, "bpe_encode_batch_spans", counting)
    monkeypatch.setattr(tok, "_oracle_piece", no_oracle)
    fb0, waves0 = tok.stats.host_fallback_pieces, tok.stats.device_waves
    host0 = tok.stats.host_wave_pieces
    if entry == "batch":
        got = tok.encode_batch(docs)
    else:
        chunks = [docs[i : i + 2] for i in range(0, len(docs), 2)]
        got = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
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
