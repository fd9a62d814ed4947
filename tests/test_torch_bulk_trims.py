"""GpuTokenizer's bulk trims vs the host engine's loop, exactly.

The counterpart of ``tests/test_bulk_trims.py``, case for case: each
test's docstring names its JAX test.  ``device="cpu"`` with every wave
forced onto the plain PyTorch merge (``_host_pp = inf``,
``_host_wave_max = 0``); every (text, budget, mode, specials) cell must
equal the port's host ``TikTokenizer``, ids and surviving text.
"""

from __future__ import annotations

import random

import pytest

from conftest import require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.models.registry import get_encoding_spec
from tokenizer_tpu_torch.vocab import Vocabulary

TEXTS = [
    "",
    "!",
    "Hello World, this is a somewhat longer sentence for trimming.",
    "don't CAN'T it's I'll we've",
    "numbers 1 22 333 4444 55555 123456789",
    "  leading spaces   and   runs  ",
    "line\nbreaks\r\nand\rreturns \n \n mixed \n\n\n",
    "unicode ⭐ étoile Straße ñandú",
    "CJK 你好世界 こんにちは 안녕하세요 with tails",
    "emoji 💩 👍🏽 astral pairs 𝄞 music",
    "a" * 300,
    "x<|endoftext|>y<|endoftext|>z tail",
    "<|endoftext|>lead",
]

BUDGETS = [0, 1, 2, 3, 5, 8, 13, 40, 10_000]


def forced_port(name: str, **options):
    require_vocab(name)
    return forced(tt.create_by_encoder_name(name, allow_fetch=False, device="cpu", **options))


@pytest.fixture(scope="module")
def gpu_tok():
    return forced_port("gpt2")


@pytest.fixture(scope="module")
def host_tok():
    require_vocab("gpt2")
    return tt.create_by_encoder_name("gpt2", allow_fetch=False, device=None)


@pytest.mark.parametrize("allowed", [None, "all"])
@pytest.mark.parametrize("mode", ["ts", "cs"])
def test_trim_suffix_batch_parity(gpu_tok, host_tok, allowed, mode):
    """test_bulk_trims.py::test_trim_suffix_batch_parity"""
    for budget in BUDGETS:
        got = gpu_tok.encode_trim_suffix_batch(TEXTS, budget, allowed_special=allowed, mode=mode)
        for text, res in zip(TEXTS, got):
            expect = host_tok.encode_trim_suffix(text, budget, allowed_special=allowed, mode=mode)
            assert res.token_ids == expect.token_ids, (text, budget, mode)
            assert res.text == expect.text, (text, budget, mode)
    assert gpu_tok.stats.device_pieces > 0


@pytest.mark.parametrize("allowed", [None, "all"])
def test_trim_prefix_batch_parity(gpu_tok, host_tok, allowed):
    """test_bulk_trims.py::test_trim_prefix_batch_parity"""
    for budget in BUDGETS:
        got = gpu_tok.encode_trim_prefix_batch(TEXTS, budget, allowed_special=allowed)
        for text, res in zip(TEXTS, got):
            expect = host_tok.encode_trim_prefix(text, budget, allowed_special=allowed)
            assert res.token_ids == expect.token_ids, (text, budget)
            assert res.text == expect.text, (text, budget)


def test_per_text_budgets(gpu_tok, host_tok):
    """test_bulk_trims.py::test_per_text_budgets"""
    budgets = list(range(1, len(TEXTS) + 1))
    got = gpu_tok.encode_trim_suffix_batch(TEXTS, budgets)
    for text, b, res in zip(TEXTS, budgets, got):
        assert (res.token_ids, res.text) == tuple(host_tok.encode_trim_suffix(text, b)), (text, b)


def test_trim_batch_on_cl100k_synth():
    """test_bulk_trims.py::test_trim_batch_on_cl100k_synth"""
    tok = forced_port("cl100k_synth")
    host = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=None)
    for budget in (1, 4, 9, 50):
        got = tok.encode_trim_suffix_batch(TEXTS, budget, allowed_special="all")
        for text, res in zip(TEXTS, got):
            expect = host.encode_trim_suffix(text, budget, allowed_special="all")
            assert (res.token_ids, res.text) == tuple(expect), (text, budget)
        gotp = tok.encode_trim_prefix_batch(TEXTS, budget, allowed_special="all")
        for text, res in zip(TEXTS, gotp):
            expect = host.encode_trim_prefix(text, budget, allowed_special="all")
            assert (res.token_ids, res.text) == tuple(expect), (text, budget)
    assert tok.stats.device_pieces > 0


def test_fuzz_trim_parity(gpu_tok, host_tok):
    """test_bulk_trims.py::test_fuzz_trim_parity"""
    rng = random.Random(77)
    alphabet = "abc ABC 123 \n\r\t ⭐你好 é 💩 '! .,<|endoftext|>"
    for _ in range(120):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 50)))
        budget = rng.randint(0, 25)
        mode = rng.choice(["ts", "cs"])
        allowed = rng.choice([None, "all"])
        got = gpu_tok.encode_trim_suffix_batch([text], budget, allowed_special=allowed, mode=mode)[0]
        expect = host_tok.encode_trim_suffix(text, budget, allowed_special=allowed, mode=mode)
        assert (got.token_ids, got.text) == tuple(expect), (text, budget, mode, allowed)
        gp = gpu_tok.encode_trim_prefix_batch([text], budget, allowed_special=allowed)[0]
        ep = host_tok.encode_trim_prefix(text, budget, allowed_special=allowed)
        assert (gp.token_ids, gp.text) == tuple(ep), (text, budget, allowed)


def test_trim_batch_is_budget_aware(gpu_tok, host_tok):
    """test_bulk_trims.py::test_trim_batch_is_budget_aware"""
    doc = ("budget aware trims never assemble everything " * 64 + "\n") * 64
    base = gpu_tok.stats.tokens_out
    got = gpu_tok.encode_trim_suffix_batch([doc], 8)[0]
    grew = gpu_tok.stats.tokens_out - base
    assert grew <= 64, f"suffix trim assembled {grew} ids for budget 8"
    assert (got.token_ids, got.text) == tuple(host_tok.encode_trim_suffix(doc, 8))

    base = gpu_tok.stats.tokens_out
    gp = gpu_tok.encode_trim_prefix_batch([doc], 8)[0]
    grew = gpu_tok.stats.tokens_out - base
    assert grew <= 64, f"prefix trim assembled {grew} ids for budget 8"
    assert (gp.token_ids, gp.text) == tuple(host_tok.encode_trim_prefix(doc, 8))


def test_trim_batch_mixed_budgets(gpu_tok, host_tok):
    """test_bulk_trims.py::test_trim_batch_mixed_budgets"""
    budgets = [(i * 7 + 1) % 45 for i in range(len(TEXTS))]
    budgets[0] = 0
    budgets[-1] = 10000
    for mode in ("ts", "cs"):
        got = gpu_tok.encode_trim_suffix_batch(TEXTS, budgets, allowed_special="all", mode=mode)
        for t, b, res in zip(TEXTS, budgets, got):
            want = host_tok.encode_trim_suffix(t, b, allowed_special="all", mode=mode)
            assert (res.token_ids, res.text) == tuple(want), (t, b, mode)
    gotp = gpu_tok.encode_trim_prefix_batch(TEXTS, budgets, allowed_special="all")
    for t, b, res in zip(TEXTS, budgets, gotp):
        want = host_tok.encode_trim_prefix(t, b, allowed_special="all")
        assert (res.token_ids, res.text) == tuple(want), (t, b)


def test_trim_batch_degenerate_budget_before_rotation(host_tok):
    """test_bulk_trims.py::test_trim_batch_degenerate_budget_before_rotation"""
    require_vocab("gpt2")
    spec = get_encoding_spec("gpt2")
    v = Vocabulary.for_encoding("gpt2", allow_fetch=False)
    tok = forced(GpuTokenizer(v, spec.special_tokens, spec.pattern, max_unique_rows=600, device="cpu"))
    big = " ".join(f"w{i} {i}" for i in range(200)) + " tail piece here"
    docs = ["hello world " * 120, big]
    budgets = [0, 7]
    for mode in ("ts", "cs"):
        got = tok.encode_trim_suffix_batch(docs, budgets, mode=mode)
        for t, b, res in zip(docs, budgets, got):
            want = host_tok.encode_trim_suffix(t, b, mode=mode)
            assert (res.token_ids, res.text) == tuple(want), (b, mode)
    gotp = tok.encode_trim_prefix_batch(docs, budgets)
    for t, b, res in zip(docs, budgets, gotp):
        want = host_tok.encode_trim_prefix(t, b)
        assert (res.token_ids, res.text) == tuple(want), b
        assert res.token_ids or b == 0 or not t
    assert tok.stats.device_pieces > 0
