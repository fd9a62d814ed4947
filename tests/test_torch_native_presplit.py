"""The port's native scanner against the JAX scanner's own suite.

``tests/test_native_presplit.py``, case for case, against
``tokenizer_tpu_torch.runtime.native`` (the port's ``presplit.cpp``,
which has diverged from the JAX copy: its counters, its lock-free
intern, its wave packer) with the port's own registry patterns,
``Vocabulary`` and ``bpe``.  Each test's docstring names its JAX
counterpart.  Every test asserts piece-for-piece byte equality between
the port's ``presplit`` and the `regex` module compiling the same
pattern, or the port's native merge against the port's Python oracle.
"""

import random
import string

import pytest

import regex as _regex

from conftest import require_vocab

from tokenizer_tpu_torch.models.registry import (
    REGEX_PATTERN_1,
    REGEX_PATTERN_2,
    REGEX_PATTERN_3,
)
from tokenizer_tpu_torch.runtime import native

if not native.available():
    pytest.skip("native presplit unavailable (no toolchain)", allow_module_level=True)

PATTERNS = [
    (REGEX_PATTERN_1, 1),
    (REGEX_PATTERN_2, 2),
    (REGEX_PATTERN_3, 3),
]
_COMPILED = {pid: _regex.compile(pat) for pat, pid in PATTERNS}


def _python_pieces(text: str, pid: int):
    return [m.group(0).encode("utf-8") for m in _COMPILED[pid].finditer(text)]


def _native_pieces(text: str, pid: int):
    data = text.encode("utf-8")
    ends = native.presplit(data, pid)
    out = []
    prev = 0
    for e in ends:
        out.append(data[prev:e])
        prev = int(e)
    assert prev == len(data), "native pieces must cover the input"
    return out


def _check(text: str, pid: int):
    assert _native_pieces(text, pid) == _python_pieces(text, pid), (
        pid,
        repr(text),
    )


EDGE_CASES = [
    "",
    "Hello World",
    "hello world how are you",
    "  leading",
    "trailing  ",
    "   ",
    " ",
    "\t",
    "\t\tx",
    "a\tb",
    "don't can't won't it's I'll we've they'd I'm you're",
    "DON'T CAN'T WON'T IT'S I'LL WE'VE THEY'D I'M YOU'RE",
    "dOn'T iT'S i'Ll wE'vE ThEy'D yOu'Re a'eR b'rE c'lL d'Ll",
    "'s 't 're 've 'm 'll 'd 'S 'T 'RE 'VE 'M 'LL 'D",
    "'x '' ' 'r 'v 'l 're've'll",
    "1 22 333 4444 55555 123456789012345",
    "x1y22z333",
    "mixed123abc456def 12.34 1,000,000",
    "!@#$%^&*()_+-=[]{}|;:'\",.<>?/~`",
    "a!b@c#d",
    " !! ",
    "!!\n",
    "!!\r\n\r\n",
    " !!\n\nx",
    "\n",
    "\r\n",
    "\n\n\n",
    "a\nb",
    "a\n\nb",
    "a \n b",
    "  \n\n  x",
    " \r\n \r\n ",
    "x\r",
    "\rx",
    "unicode ⭐ ✨ ♥ ÿ é ü ñ",
    "emoji 💩 👍🏽 👨‍👩‍👧‍👦 🇺🇸",
    "CJK 你好世界 こんにちは 안녕하세요",
    "arabic مرحبا بالعالم hebrew שלום עולם",
    "HELLO World hello WORLD HeLLo hELLO",
    "XMLHttpRequest parseHTML HTMLElement",
    "snake_case camelCase PascalCase SCREAMING_SNAKE",
    "a'b'c''d",
    "in/out a/b/c //comment /usr/local/bin",
    "path\\to\\file c:\\windows",
    "\u00a0\u2028\u2029\u3000 ideographic space",
    "\x0b\x0c vertical tab form feed",
    "combining a\u0301 e\u0301 \u0301alone",
    "ʰʱʲ modifier letters ᄀᄁ",
    "ｆｕｌｌｗｉｄｔｈ ＡＢＣ １２３",
    "ⅣⅤⅥ roman numerals ½ ¾",
    "ــــ tatweel وصل",
    "🙂x🙂 🙂 x 🙂",
    "𝕸𝖆𝖙𝖍 𝐁𝐨𝐥𝐝 𝒸𝓊𝓇𝓈𝒾𝓋𝑒",
]


@pytest.mark.parametrize("pid", [1, 2, 3])
@pytest.mark.parametrize("idx", range(len(EDGE_CASES)))
def test_edge_cases(pid, idx):
    """JAX: ``test_native_presplit.py::test_edge_cases``."""
    _check(EDGE_CASES[idx], pid)


@pytest.mark.parametrize("pid", [1, 2, 3])
def test_conformance_corpus(pid, lib_rs_text):
    """JAX: ``test_native_presplit.py::test_conformance_corpus``."""
    _check(lib_rs_text, pid)


@pytest.mark.parametrize("pid", [1, 2, 3])
def test_random_ascii_fuzz(pid):
    """JAX: ``test_native_presplit.py::test_random_ascii_fuzz``."""
    rng = random.Random(1000 + pid)
    alphabet = string.ascii_letters + string.digits + string.punctuation + " \t\n\r"
    for _ in range(400):
        text = "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, 80))
        )
        _check(text, pid)


@pytest.mark.parametrize("pid", [1, 2, 3])
def test_random_unicode_fuzz(pid):
    """JAX: ``test_native_presplit.py::test_random_unicode_fuzz``."""
    rng = random.Random(2000 + pid)
    pools = [
        "abcXYZ 123",
        "⭐💩你好éñ\u0301ʰ",
        " \t\n\r\u00a0\u3000",
        "'’!./-_",
        "ΑΒΓαβγ ЖЗИжзи",
        "𝒜𝒷𝕔 𝟙𝟚𝟛",
    ]
    alphabet = "".join(pools)
    for _ in range(400):
        text = "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, 60))
        )
        _check(text, pid)


@pytest.mark.parametrize("pid", [1, 2, 3])
def test_random_codepoint_fuzz(pid):
    """JAX: ``test_native_presplit.py::test_random_codepoint_fuzz``."""
    rng = random.Random(3000 + pid)
    for _ in range(200):
        chars = []
        for _ in range(rng.randint(1, 40)):
            cp = rng.choice(
                [
                    rng.randint(0x20, 0x7E),
                    rng.randint(0xA0, 0x2FFF),
                    rng.randint(0x1F000, 0x1FAFF),
                    rng.randint(0x0300, 0x036F),  # combining marks
                    0x27,  # apostrophe
                    0x20,
                    0x0A,
                    0x0D,
                ]
            )
            chars.append(chr(cp))
        _check("".join(chars), pid)


def test_split_context_dedup_consistency(lib_rs_text):
    """JAX: ``test_native_presplit.py::test_split_context_dedup_consistency``.
    The production interning context (SplitContext) deduplicates
    exactly: every piece's uid maps back to its own bytes, uids are
    stable across calls, and distinct pieces get distinct uids."""
    data = lib_rs_text.encode("utf-8")
    for pid in (1, 2, 3):
        ends = native.presplit(data, pid)
        ctx = native.SplitContext(pid)
        uids, news = ctx.split(data)
        assert len(uids) == len(ends)
        by_uid = dict(news)
        # Every news uid is fresh and its bytes round-trip.
        assert len(by_uid) == len(news) == ctx.n_pieces
        # Reconstruct each piece through the unique table.
        prev = 0
        for k, e in enumerate(ends):
            assert by_uid[int(uids[k])] == data[prev:e]
            prev = int(e)
        # Unique pieces really are unique.
        assert len(set(by_uid.values())) == len(by_uid)
        # A second pass interns nothing new and returns identical uids.
        uids2, news2 = ctx.split(data)
        assert not news2
        assert (uids2 == uids).all()


def test_split_batch_uid_generation_guard(lib_rs_text):
    """JAX: ``test_native_presplit.py::test_split_batch_uid_generation_guard``.
    A uid buffer older than the ring depth must fail loudly."""
    import numpy as np

    data = lib_rs_text.encode("utf-8")[:4096]
    ctx = native.SplitContext(1)
    seg = (np.array([0], np.int64), np.array([len(data)], np.int64))
    ctx.split_batch(data, *seg)
    gen = ctx.generation
    ctx.check_uid_generation(gen)  # fresh: fine
    for _ in range(ctx._RING):
        ctx.split_batch(data, *seg)
    with pytest.raises(RuntimeError, match="recycled"):
        ctx.check_uid_generation(gen)


def test_segment_windows():
    """JAX: ``test_native_presplit.py::test_segment_windows``.  presplit over
    a sub-range must match python's pos/endpos semantics."""
    text = "Hello <|x|> World  123"
    data = text.encode("utf-8")
    for pid in (1, 2, 3):
        for a, b in [(0, 5), (5, len(data)), (6, 11), (0, 0)]:
            ends = native.presplit(data, pid, a, b)
            py = [
                m.group(0).encode()
                for m in _COMPILED[pid].finditer(text, a, b)
            ]
            got, prev = [], a
            for e in ends:
                got.append(data[prev:e])
                prev = int(e)
            assert got == py, (pid, a, b)


@pytest.fixture(scope="module")
def gpt2_vocab():
    """The port's own gpt2 ``Vocabulary``."""
    require_vocab("gpt2")
    from tokenizer_tpu_torch.vocab import Vocabulary

    return Vocabulary.for_encoding("gpt2", allow_fetch=False)


def test_native_bpe_matches_python_oracle(gpt2_vocab):
    """JAX: ``test_native_presplit.py::test_native_bpe_matches_python_oracle``.
    tt_bpe_encode (heap merge over the pair table) is bit-identical
    to the reference python loop on random and pathological pieces."""
    import numpy as np

    from tokenizer_tpu_torch.bpe import byte_pair_encode

    table = gpt2_vocab.pair_table()
    rng = np.random.default_rng(11)
    cases = []
    # random ascii / bytes / unicode of many lengths, incl. > 512
    for n in (2, 3, 7, 17, 64, 129, 400, 513, 2000):
        cases.append(bytes(rng.integers(97, 123, size=n).astype(np.uint8)))
        cases.append(bytes(rng.integers(0, 256, size=n).astype(np.uint8)))
    cases.append(("好" * 700).encode("utf-8"))   # CJK run
    cases.append(b"1234567890" * 300)             # digit run
    cases.append(b" " * 1000)                     # zero-merge run (gpt2)
    cases.append(b"hello world, this is a perfectly normal sentence.")
    for piece in cases:
        want = byte_pair_encode(piece, gpt2_vocab.encoder)
        got = native.bpe_encode(piece, table).tolist()
        assert got == want, (piece[:24], len(piece))


def test_native_bpe_tie_break_first_min(gpt2_vocab):
    """JAX: ``test_native_presplit.py::test_native_bpe_tie_break_first_min``.
    Equal minimal ranks must merge at the FIRST index (strict-< scan,
    BytePairEncoder.cs:48-54): repeated bigrams exercise the tie."""
    from tokenizer_tpu_torch.bpe import byte_pair_encode

    table = gpt2_vocab.pair_table()
    for piece in (b"ababababab", b"thethethethe", b"  a  a  a  a", b"aaaa"):
        want = byte_pair_encode(piece, gpt2_vocab.encoder)
        got = native.bpe_encode(piece, table).tolist()
        assert got == want


# ---- oversized-segment subdivision (safe split points) --------------------

_SUBDIV_WORKER = r"""
import os, sys, json
sys.path.insert(0, %(repo)r)
import numpy as np
from tokenizer_tpu_torch.runtime.native import SplitContext

# Build a diverse doc large enough to subdivide many times at the
# 4 KB test threshold: prose, code, digits, CJK (no safe points inside
# the CJK stretch — exercises the no-safe-point-in-window fallback),
# contractions, mixed whitespace.
import random
rng = random.Random(7)
parts = []
for k in range(400):
    kind = k %% 6
    if kind == 0:
        parts.append(" ".join("word%%d" %% rng.randint(0, 999) for _ in range(40)))
    elif kind == 1:
        parts.append("def f_%%d(x):\n    return x + %%d  # note\n" %% (k, k) * 3)
    elif kind == 2:
        parts.append(" ".join(str(rng.randint(0, 10**9)) for _ in range(25)))
    elif kind == 3:
        parts.append("".join(chr(rng.randint(0x4E00, 0x9FFF)) for _ in range(300)))
    elif kind == 4:
        parts.append("it's  can't   won't\t\tdouble  spaced\n\n\nruns")
    elif kind == 5 and k %% 12 == 5:
        # Space-free stretch whose only candidates are '\n' cuts —
        # half after letters/digits (allowed), half after punct
        # (must be refused: p2/p3 punct pieces absorb trailing \r\n).
        parts.append("".join(
            ("w%%d\n" %% j if j %% 2 else "use fancy_regex::Regex;\n")
            for j in range(600)))
    else:
        parts.append("punct!!! (x<=y) [a]{b} ~~~ " * 10)
doc = " ".join(parts)
data = doc.encode("utf-8")

out = {}
for pid in (1, 2, 3):
    ctx = SplitContext(pid)
    uids, offs, counts, news = ctx.split_batch(
        data, np.array([0]), np.array([len(data)])
    )
    n = int(counts[0])
    # Reconstruct piece byte-lengths from first-occurrence spans.
    spans = {int(u): (int(s), int(e)) for u, s, e in zip(*news)}
    pieces = [data[spans[int(u)][0] : spans[int(u)][1]] for u in uids[:n]]
    out[pid] = [len(p) for p in pieces], sum(len(p) for p in pieces)
    assert out[pid][1] == len(data), (pid, out[pid][1], len(data))
print("PIECES " + json.dumps({p: [len(v[0]), v[1]] for p, v in out.items()}))
# Digest of the full piece-length sequence: with the concatenation
# pinned to the input (asserted above), equal length sequences imply
# equal piece content.
import hashlib
h = {p: hashlib.blake2b(repr(out[p][0]).encode()).hexdigest() for p in out}
print("DIGEST " + json.dumps(h))
"""


def test_subdivided_split_matches_whole_segment(tmp_path):
    """JAX: ``test_native_presplit.py::test_subdivided_split_matches_whole_segment``.
    A giant single-segment doc must split identically whether the
    native layer subdivides it (4 KB test threshold) or scans it whole
    (threshold above the doc size)."""
    import os
    import subprocess
    import sys as _sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    worker = _SUBDIV_WORKER % {"repo": repo}
    outs = {}
    for name, sub in (("subdiv", "4096"), ("whole", "1073741824")):
        env = dict(os.environ)
        env["TOKENIZER_TPU_SUBSEG_BYTES"] = sub
        p = subprocess.run(
            [_sys.executable, "-c", worker],
            capture_output=True,
            text=True,
            timeout=240,
            env=env,
        )
        assert p.returncode == 0, p.stderr[-2000:]
        outs[name] = [
            l for l in p.stdout.splitlines() if l.startswith(("PIECES", "DIGEST"))
        ]
    assert outs["subdiv"] == outs["whole"]
