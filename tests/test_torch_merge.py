"""The port's plain PyTorch merge and probe vs the JAX package, exactly.

The same numpy-made tiles go through ``merge_packed_torch`` (the CPU
route of ``tokenizer_tpu_torch.ops.merge_cuda.merge_packed``), the JAX
package's XLA ``merge_packed_jax``, its Pallas kernel in interpret mode
and the NumPy model ``merge_packed_numpy``.  Everything is int32, so the
tolerance is zero: full output tiles and counts must be equal.
"""

import numpy as np
import pytest
import regex as _regex
import torch

import jax.numpy as jnp

from tokenizer_tpu.models.registry import REGEX_PATTERN_1
from tokenizer_tpu.ops import merge_jax
from tokenizer_tpu.ops.merge_numpy import merge_packed_numpy
from tokenizer_tpu.ops.packing import BUCKETS
from tokenizer_tpu.ops.pair_table import MAX_RANK, PairTable
from tokenizer_tpu.vocab import Vocabulary
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.ops.merge_torch import (
    device_table,
    lookup_pairs_torch,
    merge_packed_torch,
)


def _pack(pieces, table, L, B):
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c, p in enumerate(pieces):
        ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    return ids, lengths


def _lanes(n):
    return max(-(-n // 128) * 128, 128)


def _torch_merge(table, ids, lengths):
    out_ids, out_n = merge_packed_torch(
        device_table(table, "cpu"),
        torch.from_numpy(ids),
        torch.from_numpy(lengths),
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    )
    return out_ids.numpy(), out_n.numpy()


def _jax_merge(table, ids, lengths):
    out_ids, out_n = merge_jax.jit_merge_fn(table)(
        merge_jax.device_table(table), jnp.asarray(ids), jnp.asarray(lengths)
    )
    return np.asarray(out_ids), np.asarray(out_n)


def _assert_all_equal(table, ids, lengths):
    """torch == jax == numpy on the full tile and the counts."""
    t_ids, t_n = _torch_merge(table, ids, lengths)
    j_ids, j_n = _jax_merge(table, ids, lengths)
    n_ids, n_n = merge_packed_numpy(ids, lengths, table)
    np.testing.assert_array_equal(t_n, j_n)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_n, n_n)
    np.testing.assert_array_equal(t_ids, n_ids)
    return t_ids, t_n


@pytest.fixture(scope="module")
def toy():
    enc = {bytes([b]): b for b in range(256)}
    for i, tok in enumerate([b"ab", b"cd", b"ef", b"abcd", b"cdef", b"abc", b"bc", b"bcd"]):
        enc[tok] = 256 + i
    v = Vocabulary(enc, name="toy")
    return v, PairTable.build(v, verify_closure=False)


@pytest.fixture(scope="module")
def vreg_toy():
    """The <= 128-slot table the Pallas kernel can address."""
    enc = {bytes([b]): b for b in range(256)}
    for tok in [
        b"ab", b"cd", b"ef", b"abcd", b"cdef", b"abc", b"abcdef",
        b"he", b"ll", b"llo", b"hello", b" h", b" hello",
        b"12", b"123", b"1234", b"  ", b"    ",
    ]:
        enc[tok] = len(enc)
    v = Vocabulary(enc, name="toy")
    return v, v.pair_table()


# -- lookup ---------------------------------------------------------------


def test_lookup_pairs_torch_matches_pair_table_and_jax(gpt2_pair_table):
    table = gpt2_pair_table
    rng = np.random.default_rng(7)
    keys = np.nonzero(table.key_left >= 0)[0]
    hits = rng.choice(keys, 3000, replace=False)
    near = np.int32(2**31 - 1)
    left = np.concatenate(
        [
            table.key_left[hits],
            rng.integers(0, table.n_vocab, 3000),  # mostly misses
            [-1, 5, -1, -7, near, near - 1, near, 0, 300],
        ]
    ).astype(np.int32)
    right = np.concatenate(
        [
            table.key_right[hits],
            rng.integers(0, table.n_vocab, 3000),
            [5, -1, -1, 3, near, 17, 0, near - 2, near],
        ]
    ).astype(np.int32)
    want = table.lookup(left, right)
    got = lookup_pairs_torch(
        device_table(table, "cpu"),
        table.slot_bits,
        table.max_probes,
        torch.from_numpy(left),
        torch.from_numpy(right),
    ).numpy()
    jax_out = np.asarray(
        merge_jax.lookup_pairs(
            merge_jax.device_table(table),
            table.slot_bits,
            table.max_probes,
            jnp.asarray(left),
            jnp.asarray(right),
        )
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_out)
    assert (got[:3000] == table.values[hits]).all()
    assert (got[-9:] == MAX_RANK).all()
    # The wrapper's CPU route is the same function.
    got_w = merge_cuda.lookup_pairs(
        device_table(table, "cpu"),
        torch.from_numpy(left),
        torch.from_numpy(right),
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    ).numpy()
    np.testing.assert_array_equal(got_w, want)


def test_device_table_from_pair_table_and_jax_dict(gpt2_pair_table):
    table = gpt2_pair_table
    a = device_table(table, "cpu")
    b = device_table(merge_jax.device_table(table), "cpu")
    for k in ("key_left", "key_right", "values"):
        assert a[k].dtype == torch.int32 and a[k].is_contiguous()
        np.testing.assert_array_equal(a[k].numpy(), getattr(table, k))
        assert torch.equal(a[k], b[k])


# -- merge: the cases of tests/test_packed_merge.py -----------------------


def test_toy_pieces(toy):
    _vocab, table = toy
    pieces = [
        b"ab", b"abc", b"abcd", b"abcdef", b"fedcba", b"aabbcc", b"xyz",
        b"bcd", b"abcdabcd", b"aaaaaaa",
    ]
    _assert_all_equal(table, *_pack(pieces, table, 16, 128))


def test_tie_break_first_index():
    enc = {bytes([b]): b for b in range(256)}
    enc[b"aa"] = 256
    enc[b"aaaa"] = 257
    table = PairTable.build(Vocabulary(enc, name="ties"), verify_closure=False)
    pieces = [b"aa", b"aaa", b"aaaa", b"aaaaa", b"aaaaaa", b"a" * 15]
    out_ids, out_n = _assert_all_equal(table, *_pack(pieces, table, 16, 128))
    # "aaaaa" -> [aaaa, a]: first-index merges only.
    assert list(out_ids[: out_n[3], 3]) == [257, ord("a")]


def test_gpt2_fuzz_pieces(gpt2_vocab, gpt2_pair_table):
    import random

    rng = random.Random(42)
    pieces = [
        bytes(rng.randrange(256) for _ in range(rng.randint(2, 16)))
        for _ in range(512)
    ]
    _assert_all_equal(gpt2_pair_table, *_pack(pieces, gpt2_pair_table, 16, 512))
    toks = [t for t in gpt2_vocab.encoder if 2 <= len(t) <= 16]
    pieces = rng.sample(toks, 512)
    out_ids, out_n = _assert_all_equal(
        gpt2_pair_table, *_pack(pieces, gpt2_pair_table, 16, 512)
    )
    # Every vocab token merges back to itself.
    assert (out_n == 1).all()
    assert list(out_ids[0]) == [gpt2_vocab.encoder[p] for p in pieces]


def test_gpt2_conformance_pieces(gpt2_pair_table, lib_rs_text):
    pat = _regex.compile(REGEX_PATTERN_1)
    pieces = sorted({m.group(0).encode("utf-8") for m in pat.finditer(lib_rs_text)})
    pieces = [p for p in pieces if 2 <= len(p) <= 64]
    _assert_all_equal(
        gpt2_pair_table, *_pack(pieces, gpt2_pair_table, 64, _lanes(len(pieces)))
    )


@pytest.mark.parametrize("L", BUCKETS)
def test_random_tiles_every_bucket(gpt2_pair_table, lib_rs_text, L):
    """Real text windows of 2..L bytes, plus CJK and digit runs, with
    empty trailing columns, at every packer bucket."""
    table = gpt2_pair_table
    rng = np.random.default_rng(L)
    text = lib_rs_text.encode("utf-8")
    pieces = []
    for k in range(200):
        n = int(rng.integers(2, L + 1))
        if k % 4 == 3:
            cps = rng.integers(0x4E00, 0x4E00 + 2000, size=max(1, n // 3))
            pieces.append("".join(map(chr, cps)).encode("utf-8")[:L])
        elif k % 4 == 2:
            pieces.append(bytes(rng.integers(48, 58, size=n).astype(np.uint8)))
        else:
            s = int(rng.integers(0, len(text) - n))
            pieces.append(text[s : s + n])
    ids, lengths = _pack(pieces, table, L, 256)  # columns 200..255 stay empty
    _out_ids, out_n = _assert_all_equal(table, ids, lengths)
    assert (out_n[200:] == 0).all()


def test_single_row_and_degenerate_columns(toy):
    _vocab, table = toy
    ids = np.full((1, 128), -1, np.int32)
    ids[0, :3] = [97, 98, 99]
    lengths = np.zeros(128, np.int32)
    lengths[:3] = 1
    _assert_all_equal(table, ids, lengths)


# -- merge: the Pallas kernel's cases (interpret mode) ---------------------


def _pallas_merge(table, ids, lengths):
    from tokenizer_tpu.ops.merge_pallas import jit_pallas_merge_fn, pallas_device_table

    out_ids, out_n = jit_pallas_merge_fn(table)(
        pallas_device_table(table, ids.shape[0]), ids, lengths, interpret=True
    )
    return np.asarray(out_ids), np.asarray(out_n)


def _random_pieces(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    alphabet = b"abcdefhello 1234"
    return [
        bytes(alphabet[i] for i in rng.integers(0, len(alphabet), size=rng.integers(lo, hi)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("L,B", [(16, 128), (16, 512), (8, 256)])
def test_matches_pallas_interpret(vreg_toy, L, B):
    _vocab, table = vreg_toy
    ids, lengths = _pack(_random_pieces(B - 7, 2, L + 1, seed=L * B), table, L, B)
    p_ids, p_n = _pallas_merge(table, ids, lengths)
    t_ids, t_n = _assert_all_equal(table, ids, lengths)
    np.testing.assert_array_equal(t_n, p_n)
    np.testing.assert_array_equal(t_ids, p_ids)


def test_block_convergence_independent(vreg_toy):
    _vocab, table = vreg_toy
    pieces = [b""] * 128 + [b"ab"] * 128 + [b"  hello 1234cdef"] * 128
    ids, lengths = _pack(pieces, table, 16, 384)
    p_ids, p_n = _pallas_merge(table, ids, lengths)
    t_ids, t_n = _assert_all_equal(table, ids, lengths)
    np.testing.assert_array_equal(t_n, p_n)
    np.testing.assert_array_equal(t_ids, p_ids)


# -- the wrapper ----------------------------------------------------------


def test_wrapper_cpu_route_is_plain_and_launches_nothing(toy, monkeypatch):
    _vocab, table = toy
    ids, lengths = _pack([b"abcdef", b"bcd"], table, 16, 128)
    calls = []
    real = merge_cuda.merge_packed_torch

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(merge_cuda, "merge_packed_torch", counting)
    before = merge_cuda.LAUNCHES
    out_ids, out_n = merge_cuda.merge_packed(
        device_table(table, "cpu"),
        torch.from_numpy(ids),
        torch.from_numpy(lengths),
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    )
    assert calls == [1] and merge_cuda.LAUNCHES == before
    want_ids, want_n = merge_packed_numpy(ids, lengths, table)
    np.testing.assert_array_equal(out_ids.numpy(), want_ids)
    np.testing.assert_array_equal(out_n.numpy(), want_n)
    # The output never aliases the input tile.
    assert out_ids.data_ptr() != ids.__array_interface__["data"][0]


def test_wrapper_rejects_bad_operands(toy):
    _vocab, table = toy
    tab = device_table(table, "cpu")
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    ids = torch.full((16, 128), -1, dtype=torch.int32)
    lengths = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        merge_cuda.merge_packed(tab, ids.long(), lengths, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        merge_cuda.merge_packed(tab, ids[:, :100].contiguous(), lengths[:100], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        merge_cuda.merge_packed(
            tab, torch.full((128, 16), -1, dtype=torch.int32).t(), lengths, **kw
        )
    with pytest.raises(ValueError, match="entries"):
        merge_cuda.merge_packed(tab, ids, lengths[:64], **kw)
    with pytest.raises(ValueError, match="dims"):
        merge_cuda.merge_packed(tab, ids[0], lengths, **kw)
    with pytest.raises(ValueError, match="expected"):
        merge_cuda.merge_packed(device_table(table, "meta"), ids, lengths, **kw)
    with pytest.raises(ValueError, match="cpu or cuda"):
        merge_cuda.merge_packed(
            device_table(table, "meta"), ids.to("meta"), lengths.to("meta"), **kw
        )
