"""The synthetic real-scale vocabularies through the port, against tiktoken.

The counterpart of ``tests/test_cl100k_synth.py``, case for case, for
cl100k_synth (pattern 2, 100,256 ranks) and o200k_synth (pattern 3,
199,998 ranks, the largest pair table the port serves): each test's
docstring names its JAX test.  The oracle is Rust ``tiktoken`` built from
the same ranks, pattern and real special table
(``tools/synth_goldens.py``), and the committed goldens
``tests/testdata/tokens_{cl100k,o200k}_synth.json``.  The port's
``GpuTokenizer`` runs on ``device="cpu"`` with every wave forced onto the
plain PyTorch merge (``_host_pp = inf``, ``_host_wave_max = 0``); ids
must match exactly.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

tiktoken = pytest.importorskip("tiktoken")

from conftest import find_testdata, require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import synth_goldens  # noqa: E402

_SHAPES = {
    "cl100k_synth": (100_256, 100_257),
    "o200k_synth": (199_998, 199_999),
}

CORPUS = [
    "",
    "!",
    "Hello World",
    "MixedCASE WordS aNd ACRONYMS NASA iPhone",
    "don't CAN'T it'S I'Ll we'Ve they'D THEY'RE y'eR",
    "numbers 1 22 333 4444 55555 1234 12345678",
    "  leading spaces   and   runs  ",
    "line\nbreaks\r\nand\rreturns \n \n mixed \n\n\n",
    "space before\n newline and spaces \n",
    "punct!@# $%^ &*()[]{} //path/to/file// a//b",
    "unicode ⭐ étoile Straße ñandú",
    "CJK 你好世界 こんにちは 안녕하세요",
    "emoji 💩 👍🏽 flags 🇺🇸",
    "a" * 300,
    " 123456 digits run " + "9" * 40,
    "\t\t tabs \t ",
]


def _gen_corpus(mb: float, seed: int) -> list:
    sys.path.insert(0, str(REPO))
    from bench import gen_corpus

    return gen_corpus(mb, seed=seed)


@pytest.fixture(scope="module", params=list(_SHAPES))
def synth(request):
    name = request.param
    require_vocab(name)
    host = tt.create_by_encoder_name(name, allow_fetch=False, device=None)
    gpu = forced(tt.create_by_encoder_name(name, allow_fetch=False, device="cpu"))
    return name, host, gpu, synth_goldens.rust_encoding(name)


def test_vocab_shape(synth):
    """test_cl100k_synth.py::test_vocab_shape"""
    name, host, gpu, _rust = synth
    n_ranks, eot = _SHAPES[name]
    assert len(host.encoder) == n_ranks
    assert sorted(host.decoder) == list(range(n_ranks))
    assert host.special_tokens_encoder["<|endoftext|>"] == eot
    assert gpu.table.n_vocab == n_ranks and not gpu.table.unreachable_tokens


def test_host_matches_rust_tiktoken_micro(synth):
    """test_cl100k_synth.py::test_host_matches_rust_tiktoken_micro"""
    _name, host, gpu, rust = synth
    for text in CORPUS:
        expect = rust.encode(text, disallowed_special=())
        assert host.encode(text) == expect, repr(text)
        assert gpu.encode(text) == expect, repr(text)
        assert host.decode(expect) == text or "�" in host.decode(expect)


def test_host_matches_rust_tiktoken_corpus(synth):
    """test_cl100k_synth.py::test_host_matches_rust_tiktoken_corpus"""
    _name, host, _gpu, rust = synth
    for d in _gen_corpus(1.0, 20260820):
        assert host.encode(d) == rust.encode(d, disallowed_special=()), repr(d[:80])


def test_device_batch_matches_rust(synth):
    """test_cl100k_synth.py::test_device_batch_matches_rust; the stream runs
    cold (both dedup generations dropped) so that its chunks reach the merge
    too."""
    _name, _host, gpu, rust = synth
    docs = _gen_corpus(0.5, 31337) + CORPUS
    waves = gpu.stats.device_waves
    out = gpu.encode_batch(docs)
    assert gpu.stats.device_waves > waves
    for d, ids in zip(docs, out):
        assert list(ids) == rust.encode(d, disallowed_special=()), repr(d[:80])
    gpu._reset_dedup_full()
    waves = gpu.stats.device_waves
    chunks = [docs[i : i + 40] for i in range(0, len(docs), 40)]
    flat = [ids for batch in gpu.encode_batch_stream(chunks) for ids in batch]
    assert gpu.stats.device_waves >= waves + len(chunks) - 1
    assert len(flat) == len(out)
    for a, b in zip(flat, out):
        assert np.array_equal(a, b)


def test_specials_match_rust(synth):
    """test_cl100k_synth.py::test_specials_match_rust"""
    name, host, gpu, rust = synth
    texts = [
        "a<|endoftext|>b",
        "plain <|endofprompt|>",
        "<|endoftext|><|endoftext|>",
    ]
    if name == "cl100k_synth":  # FIM specials exist only on cl100k
        texts.append("<|fim_prefix|>head<|fim_suffix|>tail<|fim_middle|>mid")
    for t in texts:
        expect = rust.encode(t, allowed_special="all")
        assert host.encode(t, allowed_special="all") == expect, repr(t)
        assert list(gpu.encode_batch([t], allowed_special="all")[0]) == expect, repr(t)
    t = "x<|endoftext|>y"
    assert host.encode(t) == rust.encode(t, disallowed_special=())
    assert list(gpu.encode_batch([t])[0]) == rust.encode(t, disallowed_special=())


def test_trims_on_synth_vocab(synth):
    """test_cl100k_synth.py::test_trims_on_synth_vocab; the bulk trims of the
    forced tokenizer must equal the host's."""
    _name, host, gpu, _rust = synth
    text = "The quick brown fox jumps over the lazy dog 你好 1234!"
    full = host.encode(text)
    budgets = (1, 3, 5, 8, len(full), len(full) + 5)
    for budget in budgets:
        ids, trimmed = host.encode_trim_suffix(text, budget)
        assert len(ids) <= budget
        assert ids == full[: len(ids)]
        assert text.startswith(trimmed)
        ids_p, trimmed_p = host.encode_trim_prefix(text, budget)
        assert len(ids_p) <= budget
        assert ids_p == full[len(full) - len(ids_p) :]
        assert text.endswith(trimmed_p) or "�" in trimmed_p
    texts = [text] * len(budgets)
    for b, res in zip(budgets, gpu.encode_trim_suffix_batch(texts, list(budgets))):
        assert (res.token_ids, res.text) == tuple(host.encode_trim_suffix(text, b))
    for b, res in zip(budgets, gpu.encode_trim_prefix_batch(texts, list(budgets))):
        assert (res.token_ids, res.text) == tuple(host.encode_trim_prefix(text, b))


def test_conformance_corpus_golden(synth, lib_rs_text):
    """test_cl100k_synth.py::test_conformance_corpus_golden, and the committed
    golden file."""
    name, host, gpu, rust = synth
    expect = rust.encode(lib_rs_text, disallowed_special=())
    assert json.loads(find_testdata(f"tokens_{name}.json").read_text()) == expect
    ids = host.encode(lib_rs_text)
    assert ids == expect
    assert host.decode(ids) == lib_rs_text
    gpu._reset_dedup_full()
    (batch,) = gpu.encode_batch([lib_rs_text])
    assert list(batch) == expect
    assert gpu.decode(batch) == lib_rs_text
