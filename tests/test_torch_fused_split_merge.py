"""The port's fused scan+intern+merge route vs the JAX package's host engine.

Mirrors ``tests/test_fused_split_merge.py`` case for case.  The JAX suite
makes its ``TpuTokenizer`` host-only with ``TOKENIZER_TPU_NO_DEVICE=1``;
the port has no such switch, so each case routes every wave of a
``GpuTokenizer(device="cpu")`` to the host C++ merge with the tokenizer's
own threshold (``_host_wave_max``), as ``chip_smoke.host_reference`` does.
Every split then goes through the fused call
(``tt_ctx_split_merge_batch``; ``GpuTokenizer._scan_defer_len`` fuses
pieces of at most ``gpu.L_HOST`` bytes, as at default routing on the
card, and leaves longer ones to a wave that the host merges).  Token ids
must equal the JAX package's host engine exactly.
"""

import hashlib
import random
import sys

import numpy as np
import pytest

from conftest import require_vocab

import tokenizer_tpu_torch as tt
from tokenizer_tpu import create_by_encoder_name as create_jax
from tokenizer_tpu_torch.runtime import native

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib unavailable")

#: the JAX suite's documents (tests/test_fused_split_merge.py DOCS).
DOCS = [
    "hello world " * 8,
    "def f(x):\n    return x + 1  # comment ⭐",
    "好" * 100,  # single 300-byte piece -> 200 ids > row width: deferred
    "the quick brown fox 12345 jumps over 67890",
    "",
    "<|endoftext|>tail",
    "  mixed   whitespace\t\truns\n\n\nand 'contractions aren't rare",
    "𝄞 astral π≈3.14159 🎉🎉",
]


def _host_routed(name="gpt2"):
    require_vocab(name)
    tok = tt.create_by_encoder_name(name, allow_fetch=False, device="cpu")
    tok._host_wave_max = sys.maxsize  # every wave to the host C++ merge
    return tok


@pytest.fixture(scope="module")
def host():
    require_vocab("gpt2")
    return create_jax("gpt2", allow_fetch=False)


def test_fused_batch_parity(host):
    """JAX: ``test_fused_split_merge.py::test_fused_batch_parity``."""
    tok = _host_routed()
    got = tok.encode_batch(DOCS, allowed_special="all")
    for t, g in zip(DOCS, got):
        assert list(g) == host.encode(t, allowed_special="all"), t[:40]
    assert tok.stats.unique_pieces > 0
    assert tok.stats.host_wave_pieces == tok.stats.unique_pieces
    assert tok.stats.device_pieces == 0 and tok.stats.fused_pieces > 0
    before = tok.stats.unique_pieces
    got2 = tok.encode_batch(DOCS, allowed_special="all")
    assert tok.stats.unique_pieces == before
    for a, b in zip(got, got2):
        assert np.array_equal(a, b)


def test_fused_capacity_deferral(monkeypatch, host):
    """JAX: ``test_fused_split_merge.py::test_fused_capacity_deferral``."""
    tok = _host_routed()
    monkeypatch.setattr(tok, "_prepare_fused_capacity", lambda nbytes: None)
    got = tok.encode_batch(DOCS, allowed_special="all")
    for t, g in zip(DOCS, got):
        assert list(g) == host.encode(t, allowed_special="all"), t[:40]


def test_fused_u16_units_match_python(host):
    """JAX: ``test_fused_split_merge.py::test_fused_u16_units_match_python``."""
    tok = _host_routed()
    texts = ["ascii only", "café ⭐", "𝄞𝄞 astral", "好好好 mixed π"]
    tok.encode_batch(texts)
    for t in texts:
        for budget in (1, 2, 3, 5, 50):
            got = tok.encode_trim_suffix_batch([t], budget)[0]
            want = host.encode_trim_suffix(t, budget)
            assert got.token_ids == want.token_ids, (t, budget)
            assert got.text == want.text, (t, budget)


def test_fused_stream_parity(host):
    """JAX: ``test_fused_split_merge.py::test_fused_stream_parity``."""
    tok = _host_routed()
    chunks = [DOCS[i : i + 3] for i in range(0, len(DOCS), 3)]
    out = []
    for batch in tok.encode_batch_stream(iter(chunks), allowed_special="all"):
        out.extend(batch)
    flat_docs = [d for c in chunks for d in c]
    assert len(out) == len(flat_docs)
    for t, g in zip(flat_docs, out):
        assert list(g) == host.encode(t, allowed_special="all"), t[:40]


@pytest.mark.parametrize("enc", ["cl100k_synth", "o200k_synth"])
def test_fused_parity_patterns_2_3(enc):
    """JAX: ``test_fused_split_merge.py::test_fused_parity_patterns_2_3``."""
    tok = _host_routed(enc)
    host2 = create_jax(enc, allow_fetch=False)
    got = tok.encode_batch(DOCS, allowed_special="all")
    for t, g in zip(DOCS, got):
        assert list(g) == host2.encode(t, allowed_special="all"), t[:40]
    assert tok.stats.unique_pieces > 0 and tok.stats.fused_pieces > 0


def test_fused_fuzz_vs_oracle(host):
    """JAX: ``test_fused_split_merge.py::test_fused_fuzz_vs_oracle``."""
    rng = random.Random(0xF05E)
    pools = [
        lambda: "".join(
            chr(rng.choice([32, 10, 9] + list(range(97, 123))))
            for _ in range(rng.randint(1, 40))
        ),
        lambda: "".join(chr(rng.randint(0x4E00, 0x9FFF)) for _ in range(rng.randint(1, 60))),
        lambda: "".join(chr(rng.randint(0x1F300, 0x1F64F)) for _ in range(rng.randint(1, 8))),
        lambda: str(rng.randint(0, 10 ** rng.randint(1, 12))),
        lambda: " '" + rng.choice(["s", "t", "re", "ve", "LL", "D"]),
    ]
    docs = ["".join(rng.choice(pools)() for _ in range(rng.randint(1, 12))) for _ in range(80)]
    tok = _host_routed()
    got = tok.encode_batch(docs)
    for t, g in zip(docs, got):
        assert list(g) == host.encode(t), repr(t[:50])
    assert tok.stats.fused_pieces > 0


def test_split_merge_batch_low_level(host):
    """JAX: ``test_fused_split_merge.py::test_split_merge_batch_low_level``:
    the port's own native entry point, on the port's own pair table."""
    table = _host_routed().table
    ctx = native.SplitContext(1)
    data = b"hello world hello brave new world"
    rows = np.zeros((64, 16), np.int32)
    row_len = np.zeros(64, np.int32)
    row_u16 = np.zeros(64, np.int32)
    uid_rows = np.full(64, -9, np.int32)
    uids, offs, counts, news, n_rows, n_fused, n_copied = ctx.split_merge_batch(
        data, np.array([0]), np.array([len(data)]), table, rows, row_len, row_u16, uid_rows, 0
    )
    assert len(news[0]) == 0
    assert n_fused == n_rows > 0 and n_copied == 0
    n = int(counts[0])
    got = []
    for u in uids[:n]:
        r = uid_rows[u]
        got.extend(rows[r, : row_len[r]].tolist())
    assert got == host.encode(data.decode())
    assert n_fused == len(set(uids[:n].tolist()))


def test_giant_segment_item_parallel_assemble(host):
    """JAX: ``test_fused_split_merge.py::test_giant_segment_item_parallel_assemble``."""

    def word(i):
        h = hashlib.blake2b(str(i).encode(), digest_size=4).digest()
        return "".join(chr(97 + b % 26) for b in h)

    parts = []
    for i in range(70000):  # ~2 pieces a word: over 140k pieces in one segment
        parts.append(word(i))
        if i % 9000 == 0:
            parts.append("好" * 120)  # merges to over 128 ids: an overflow row
    doc = " ".join(parts)
    tok = _host_routed()
    got = tok.encode_batch([doc])[0]
    assert list(got) == host.encode(doc)
    assert (tok._row_len[: tok._n_rows] < 0).sum() > 0
