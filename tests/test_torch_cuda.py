"""The CUDA kernels on the card vs their plain PyTorch versions, exactly.

Every test here needs an NVIDIA card with nvcc (``-m cuda``) and skips
without one; run them on the card with
``python -m pytest tests/test_torch_cuda.py -q``.  Tiles are made from a
seed with numpy and go through the kernel and the plain version on the
same device; int32 throughout, so the tolerance is zero.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import find_testdata, require_vocab

from tokenizer_tpu.ops.merge_numpy import merge_packed_numpy
from tokenizer_tpu.ops.packing import BUCKETS
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.ops.merge_torch import device_table, merge_packed_torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (phase 9's in-flight cases)

sys.path.insert(0, str(REPO / "tools"))
import bench_entries  # noqa: E402  (the cases BENCHMARK.json does not hold)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU interpret mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _tile(table, text: bytes, L: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c in range(B - 37):  # trailing columns stay empty
        n = int(rng.integers(2, L + 1))
        s = int(rng.integers(0, len(text) - n))
        ids[:n, c] = table.byte_to_id[np.frombuffer(text[s : s + n], np.uint8)]
        lengths[c] = n
    return ids, lengths


@pytest.mark.parametrize("L", BUCKETS)
def test_merge_kernel_matches_plain(cuda, gpt2_pair_table, lib_rs_text, L):
    table = gpt2_pair_table
    tab = device_table(table, cuda)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    ids, lengths = _tile(table, lib_rs_text.encode(), L, 1024, seed=L)
    di, dl = torch.from_numpy(ids).to(cuda), torch.from_numpy(lengths).to(cuda)
    before = merge_cuda.LAUNCHES
    k_ids, k_n = merge_cuda.merge_packed(tab, di, dl, **kw)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES == before + 1
    p_ids, p_n = merge_packed_torch(tab, di, dl, **kw)
    assert torch.equal(k_n, p_n) and torch.equal(k_ids, p_ids)
    v_ids, v_n = merge_cuda.merge_packed_v1(tab, di, dl, **kw)
    assert torch.equal(k_n, v_n) and torch.equal(k_ids, v_ids)
    n_ids, n_n = merge_packed_numpy(ids, lengths, table)
    np.testing.assert_array_equal(k_ids.cpu().numpy(), n_ids)
    np.testing.assert_array_equal(k_n.cpu().numpy(), n_n)


def _three_way(cuda, table, ids, lengths):
    """The kernel, the first kernel and the plain merge on one tile; all
    three must agree exactly.  Returns the kernel's (out_ids, out_n)."""
    tab = device_table(table, cuda)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    di, dl = torch.from_numpy(ids).to(cuda), torch.from_numpy(lengths).to(cuda)
    before = (merge_cuda.LAUNCHES, merge_cuda.V1_LAUNCHES)
    k_ids, k_n = merge_cuda.merge_packed(tab, di, dl, **kw)
    v_ids, v_n = merge_cuda.merge_packed_v1(tab, di, dl, **kw)
    torch.cuda.synchronize()
    assert (merge_cuda.LAUNCHES, merge_cuda.V1_LAUNCHES) == (before[0] + 1, before[1] + 1)
    p_ids, p_n = merge_packed_torch(tab, di, dl, **kw)
    assert torch.equal(k_n, v_n) and torch.equal(k_ids, v_ids)
    assert torch.equal(k_n, p_n) and torch.equal(k_ids, p_ids)
    return k_ids.cpu().numpy(), k_n.cpu().numpy()


@pytest.fixture(scope="module", params=["gpt2", "cl100k_synth"])
def merge_table(request):
    require_vocab(request.param)
    from tokenizer_tpu_torch.vocab import Vocabulary

    return Vocabulary.for_encoding(request.param, allow_fetch=False).pair_table()


@pytest.mark.parametrize("L", BUCKETS)
def test_kernel_matches_first_kernel_and_plain(cuda, merge_table, lib_rs_text, L):
    """Every bucket on both tables: windows of real text, CJK runs and digit
    runs, 2..L bytes long."""
    table = merge_table
    rng = np.random.default_rng(100 + L)
    text = lib_rs_text.encode()
    pieces = []
    for c in range(2048 - 19):  # trailing columns stay empty
        n = int(rng.integers(2, L + 1))
        kind = c % 4
        if kind == 2:  # 3-byte characters
            p = "".join(map(chr, rng.integers(0x4E00, 0x4E00 + 2000, size=max(1, n // 3))))
            p = p.encode()
        elif kind == 3:
            p = bytes(rng.integers(48, 58, size=n).astype("u1"))
        else:
            s = int(rng.integers(0, len(text) - n))
            p = text[s : s + n]
        pieces.append(p)
    ids, lengths = _pack(table, pieces, L, 2048)
    k_ids, k_n = _three_way(cuda, table, ids, lengths)
    assert (k_n < lengths).any()  # the tile merges


def test_lookup_kernel_matches_pair_table(cuda, gpt2_pair_table):
    table = gpt2_pair_table
    rng = np.random.default_rng(3)
    keys = np.nonzero(table.key_left >= 0)[0]
    hits = rng.choice(keys, 4096, replace=False)
    left = np.concatenate(
        [table.key_left[hits], rng.integers(-2, table.n_vocab, 4096), [2**31 - 1]]
    ).astype(np.int32)
    right = np.concatenate(
        [table.key_right[hits], rng.integers(-2, table.n_vocab, 4096), [2**31 - 1]]
    ).astype(np.int32)
    got = merge_cuda.lookup_pairs(
        device_table(table, cuda),
        torch.from_numpy(left).to(cuda),
        torch.from_numpy(right).to(cuda),
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    )
    np.testing.assert_array_equal(got.cpu().numpy(), table.lookup(left, right))


def test_gpu_tokenizer_golden_on_card(cuda, lib_rs_text):
    require_vocab("gpt2")
    import tokenizer_tpu_torch as tt

    tok = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cuda")
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    before = merge_cuda.LAUNCHES
    (ids,) = tok.encode_batch([lib_rs_text])
    assert list(ids) == json.loads(find_testdata("tokens_gpt2.json").read_text())
    assert merge_cuda.LAUNCHES > before and tok.stats.device_pieces > 0


def test_wrapper_rejects_mixed_devices(cuda, gpt2_pair_table):
    table = gpt2_pair_table
    ids = torch.full((16, 128), -1, dtype=torch.int32, device=cuda)
    lengths = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        merge_cuda.merge_packed(
            device_table(table, cuda),
            ids,
            lengths,
            slot_bits=table.slot_bits,
            max_probes=table.max_probes,
        )


def _pack(table, pieces, L, B):
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c, p in enumerate(pieces):
        ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    return ids, lengths


def _toy_table(extra):
    from tokenizer_tpu.ops.pair_table import PairTable
    from tokenizer_tpu.vocab import Vocabulary

    enc = {bytes([b]): b for b in range(256)}
    for tok in extra:
        enc[tok] = len(enc)
    return PairTable.build(Vocabulary(enc, name="toy"), verify_closure=False)


@pytest.mark.parametrize(
    "extra,pieces,L,B",
    [
        # first-index tie-break on runs of one byte
        ([b"aa", b"aaaa"], [b"aa", b"aaa", b"aaaaa", b"a" * 15], 16, 128),
        # blocks converge independently: empty, light and heavy blocks
        (
            [b"ab", b"cd", b"ef", b"abcd", b"cdef", b"he", b"ll", b"llo", b"hello", b" hello"],
            [b""] * 128 + [b"ab"] * 128 + [b"  hello 1234cdef"] * 128,
            16,
            384,
        ),
        # one-row and short tiles, length-1 and empty columns
        ([b"ab"], [b"a", b"b", b""], 1, 128),
        ([b"ab", b"abab"], [b"abababab", b"ba", b"b"], 8, 256),
    ],
)
def test_degenerate_tiles(cuda, extra, pieces, L, B):
    table = _toy_table(extra)
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c, p in enumerate(pieces):
        ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    tab = device_table(table, cuda)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    di, dl = torch.from_numpy(ids).to(cuda), torch.from_numpy(lengths).to(cuda)
    k_ids, k_n = merge_cuda.merge_packed(tab, di, dl, **kw)
    p_ids, p_n = merge_packed_torch(tab, di, dl, **kw)
    assert torch.equal(k_n, p_n) and torch.equal(k_ids, p_ids)
    v_ids, v_n = merge_cuda.merge_packed_v1(tab, di, dl, **kw)
    assert torch.equal(k_n, v_n) and torch.equal(k_ids, v_ids)
    n_ids, n_n = merge_packed_numpy(ids, lengths, table)
    np.testing.assert_array_equal(k_ids.cpu().numpy(), n_ids)
    np.testing.assert_array_equal(k_n.cpu().numpy(), n_n)


def test_out_of_range_lengths_and_unpadded_rows(cuda):
    """Lengths below 0 or above L are clamped, and rows at or beyond a
    column's length are copied unchanged, as the first kernel does.  Under
    the -1 padding the plain merge of the clamped lengths agrees too."""
    table = _toy_table([b"ab", b"abab", b"aa", b"aaaa"])
    L, B = 16, 128
    rng = np.random.default_rng(5)
    pieces = [b"abababababababab", b"aaaaaaaaaaaaaaaa", b"abab", b"a", b"", b"ba"] * 21
    ids, lengths = _pack(table, pieces[:B], L, B)
    lengths[:8] = [-3, -1, 0, 1, L, L + 1, L + 7, 10**6]
    clamped = np.clip(lengths, 0, L)
    k_ids, k_n = _three_way(cuda, table, ids, clamped)
    tab = device_table(table, cuda)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    got = merge_cuda.merge_packed(
        tab, torch.from_numpy(ids).to(cuda), torch.from_numpy(lengths).to(cuda), **kw
    )
    np.testing.assert_array_equal(got[0].cpu().numpy(), k_ids)
    np.testing.assert_array_equal(got[1].cpu().numpy(), k_n)
    # Garbage beyond each length: copied through, and the first kernel agrees.
    dirty = ids.copy()
    beyond = np.arange(L)[:, None] >= clamped[None, :]
    dirty[beyond] = rng.integers(0, 256, size=int(beyond.sum()))
    di, dl = torch.from_numpy(dirty).to(cuda), torch.from_numpy(lengths).to(cuda)
    d_ids, d_n = merge_cuda.merge_packed(tab, di, dl, **kw)
    v_ids, v_n = merge_cuda.merge_packed_v1(tab, di, dl, **kw)
    assert torch.equal(d_ids, v_ids) and torch.equal(d_n, v_n)
    d_ids = d_ids.cpu().numpy()
    np.testing.assert_array_equal(d_ids[beyond], dirty[beyond])
    np.testing.assert_array_equal(d_ids[~beyond], k_ids[~beyond])


def test_tie_break_on_repeated_pairs(cuda, gpt2_pair_table):
    """Runs of one byte and of digit pairs, where many pairs share the
    minimum rank and the first one must merge."""
    table = gpt2_pair_table
    pieces = []
    for n in range(2, 129):
        pieces += [b"a" * n, b"1" * n, b"0" * n, (b"12" * n)[:n], (b"aab" * n)[:n], b" " * n]
    pieces = pieces[:768]
    ids, lengths = _pack(table, pieces, 128, 768)
    k_ids, k_n = _three_way(cuda, table, ids, lengths)
    n_ids, n_n = merge_packed_numpy(ids, lengths, table)
    np.testing.assert_array_equal(k_ids, n_ids)
    np.testing.assert_array_equal(k_n, n_n)


def test_length_limit(cuda, gpt2_pair_table, lib_rs_text):
    """A tile of MAX_L rows merges like the first kernel and the plain
    merge; one row more raises and names the limit."""
    table = gpt2_pair_table
    L = merge_cuda.MAX_L
    text = lib_rs_text.encode()
    rng = np.random.default_rng(9)
    pieces = [text[s : s + n] for s, n in zip(rng.integers(0, len(text) - L, 128),
                                             rng.integers(L // 2, L + 1, 128))]
    pieces[0] = b"9" * L
    ids, lengths = _pack(table, pieces, L, 128)
    _three_way(cuda, table, ids, lengths)
    over = torch.full((L + 1, 128), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=f"MAX_L = {L}"):
        merge_cuda.merge_packed(
            device_table(table, cuda), over, torch.zeros(128, dtype=torch.int32, device=cuda),
            slot_bits=table.slot_bits, max_probes=table.max_probes,
        )


# -- the probe experiments: K3, K4, K5 ------------------------------------


@pytest.fixture(scope="module", params=["gpt2", "cl100k_synth"])
def probe_table(request):
    require_vocab(request.param)
    from tokenizer_tpu.vocab import Vocabulary

    return Vocabulary.for_encoding(request.param, allow_fetch=False).pair_table()


#: The launch counter of each probe wrapper.
_COUNTERS = {
    "probe_rows_async": "ASYNC_LAUNCHES",
    "probe_rows_resident": "RESIDENT_LAUNCHES",
    "lookup_onehot": "ONEHOT_LAUNCHES",
}


@pytest.mark.parametrize("kernel", ["probe_rows_async", "probe_rows_resident", "lookup_onehot"])
def test_probe_kernel_matches_plain_and_pair_table(cuda, probe_table, kernel):
    from tokenizer_tpu_torch.ops import probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe import arm_calls, l2_for, make_probes

    table = probe_table
    fn, plain = arm_calls(table, cuda)[kernel]
    counter = _COUNTERS[kernel]
    left, right = make_probes(table, (16, 128), seed=21)
    near = 2**31 - 1
    left[0, :4], right[0, :4] = [near, near - 1, -5, 0], [near, 3, 7, -1]
    dl, dr = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    before = getattr(probe_cuda, counter)
    with l2_for(kernel, table, cuda):
        got = fn(dl, dr)
        torch.cuda.synchronize()
    assert getattr(probe_cuda, counter) == before + 1
    assert torch.equal(got, plain(dl, dr))
    np.testing.assert_array_equal(got.cpu().numpy(), table.lookup(left, right))


@pytest.fixture(scope="module", params=["gpt2", "cl100k_synth", "o200k_synth"])
def onehot_table(request):
    require_vocab(request.param)
    from tokenizer_tpu.vocab import Vocabulary

    return Vocabulary.for_encoding(request.param, allow_fetch=False).pair_table()


def _edge_pairs(table, rng):
    """Pairs at the table's ends: keys whose home slot is in row 0 or in
    the last row, random pairs whose probe chain runs past the last slot
    into slot 0 (and some homed in row 0), and extreme and negative ids."""
    from tokenizer_tpu.ops.pair_table import hash_pair_u32

    n = table.n_slots
    keys = np.nonzero(table.key_left >= 0)[0]
    home = hash_pair_u32(table.key_left[keys], table.key_right[keys], table.slot_bits)
    first = keys[home < 128][:20]
    last = keys[home >= n - 128][:20]
    left = [table.key_left[first], table.key_left[last]]
    right = [table.key_right[first], table.key_right[last]]
    cand_l = rng.integers(0, table.n_vocab, 1 << 22).astype(np.int32)
    cand_r = rng.integers(0, table.n_vocab, 1 << 22).astype(np.int32)
    h = hash_pair_u32(cand_l, cand_r, table.slot_bits)
    wrap = np.nonzero(h >= n - table.max_probes + 1)[0][:8]
    low = np.nonzero(h < 4)[0][:8]
    assert wrap.size > 0 and low.size > 0 and first.size > 0 and last.size > 0
    left += [cand_l[wrap], cand_l[low]]
    right += [cand_r[wrap], cand_r[low]]
    near = 2**31 - 1
    left.append(np.array([near, near - 1, -5, 0, -(2**31), near], np.int32))
    right.append(np.array([near, 3, 7, -1, 1, 0], np.int32))
    return np.concatenate(left).astype(np.int32), np.concatenate(right).astype(np.int32)


@pytest.mark.parametrize("S", [1, 3, 16, 17])
def test_onehot_kernel_matches_plain_and_pair_table(cuda, onehot_table, S):
    """K5 on every table the port serves, with M ragged against the
    kernel's 256-row tile: one launch, equal to the plain version and to
    PairTable.lookup, at the table's first and last rows and across the
    wrap from the last slot to slot 0."""
    from tokenizer_tpu_torch.ops import probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe import make_probes
    from tokenizer_tpu_torch.ops.exp_probe_torch import (
        bigtable_device_table, bigtable_kmajor, lookup_onehot_torch)

    table = onehot_table
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    left, right = make_probes(table, (S, 128), seed=40 + S)
    e_l, e_r = _edge_pairs(table, np.random.default_rng(S))
    left.reshape(-1)[: e_l.size], right.reshape(-1)[: e_r.size] = e_l, e_r
    tab8 = bigtable_device_table(table, cuda)
    tab_k = bigtable_kmajor(tab8)
    dl, dr = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    before = probe_cuda.ONEHOT_LAUNCHES
    got = probe_cuda.lookup_onehot(tab_k, dl, dr, **kw)
    torch.cuda.synchronize()
    assert probe_cuda.ONEHOT_LAUNCHES == before + 1
    assert torch.equal(got, lookup_onehot_torch(tab8, dl, dr, **kw))
    want = table.lookup(left, right)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert (want != 2**31 - 1).sum() >= 16 * S  # the table's keys hit


_ROW_KERNELS = ("probe_rows_async", "probe_rows_resident")


def _row_kernel_vs_plain(cuda, table, kernel, left, right):
    """One launch of K3 or K4 on the pairs; equal to probe_rows_torch at
    the table's max_probes and to PairTable.lookup.  Returns the ids."""
    from tokenizer_tpu_torch.ops import probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe import l2_for
    from tokenizer_tpu_torch.ops.exp_probe_torch import probe_rows_torch, table_planes_2d

    planes = table_planes_2d(table, cuda)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    dl, dr = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    before = getattr(probe_cuda, _COUNTERS[kernel])
    with l2_for(kernel, table, cuda):
        got = getattr(probe_cuda, kernel)(planes, dl, dr, **kw)
        torch.cuda.synchronize()
    assert getattr(probe_cuda, _COUNTERS[kernel]) == before + 1
    assert torch.equal(got, probe_rows_torch(planes, table.slot_bits, table.max_probes, dl, dr))
    want = table.lookup(left, right)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    return want


@pytest.mark.parametrize("extra", [0, 20])
@pytest.mark.parametrize("count", [1, 31, 2049, 131072])
@pytest.mark.parametrize("kernel", _ROW_KERNELS)
def test_row_kernels_match_plain_and_pair_table(cuda, onehot_table, kernel, count, extra):
    """K3 and K4 on every table the port serves, one launch per call: the
    edge pairs (homes in row 0 and the last row, chains that wrap, extreme
    and negative ids) first, then make_probes pairs, as a 1-D tensor of
    ``count`` pairs; with max_probes 20 beyond the table's too (a second
    pass for a chain that has not ended)."""
    import dataclasses

    from tokenizer_tpu_torch.ops.exp_probe import make_probes

    table = dataclasses.replace(onehot_table, max_probes=onehot_table.max_probes + extra)
    e_l, e_r = _edge_pairs(table, np.random.default_rng(count))
    p_l, p_r = make_probes(table, (-(-count // 128), 128), seed=count)
    left = np.concatenate([e_l, p_l.reshape(-1)])[:count]
    right = np.concatenate([e_r, p_r.reshape(-1)])[:count]
    want = _row_kernel_vs_plain(cuda, table, kernel, left, right)
    if count >= 2049:
        assert (want != 2**31 - 1).sum() >= count // 4  # half of make_probes' pairs are keys


@pytest.mark.parametrize("kernel", _ROW_KERNELS)
def test_row_kernels_take_several_passes_on_a_dense_table(cuda, kernel):
    """Every key of a table whose chains are longer than one pass, and as
    many misses, some with negative ids."""
    from test_torch_probe import dense_table

    table = dense_table()
    assert table.max_probes > 32
    keys = np.nonzero(table.key_left >= 0)[0]
    rng = np.random.default_rng(2)
    left = np.concatenate([table.key_left[keys], rng.integers(-3, 1000, 300)]).astype(np.int32)
    right = np.concatenate([table.key_right[keys], rng.integers(-3, 10**6, 300)]).astype(np.int32)
    want = _row_kernel_vs_plain(cuda, table, kernel, left, right)
    np.testing.assert_array_equal(want[: keys.size], table.values[keys])


def test_onehot_wrapper_takes_only_the_prepared_table(cuda, gpt2_pair_table):
    """On the card K5 takes the K-major table on the pairs' card, aligned;
    the JAX layout, a CPU table or a misaligned one raise, and launch nothing."""
    from tokenizer_tpu_torch.ops import probe_cuda
    from tokenizer_tpu_torch.ops.exp_probe_torch import bigtable_device_table, bigtable_kmajor

    table = gpt2_pair_table
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    tab8 = bigtable_device_table(table, cuda)
    tab_k = bigtable_kmajor(tab8)
    flat = torch.empty(tab_k.numel() + 1, dtype=torch.int8, device=cuda)
    misaligned = flat[1:].view(tab_k.shape)
    pairs = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    before = probe_cuda.ONEHOT_LAUNCHES
    for bad, match in ((tab8, r"\[1536, n_rows\]"), (tab_k.cpu(), "expected"),
                       (misaligned, "aligned")):
        with pytest.raises(ValueError, match=match):
            probe_cuda.lookup_onehot(bad, pairs, pairs, **kw)
    assert probe_cuda.ONEHOT_LAUNCHES == before


def test_probe_wrappers_raise_on_misaligned_planes(cuda, gpt2_pair_table):
    from tokenizer_tpu_torch.ops import probe_cuda

    table = gpt2_pair_table
    n_rows = table.n_slots // 128
    flat = torch.zeros(3 * table.n_slots + 1, dtype=torch.int32, device=cuda)
    planes = tuple(flat[1 + k * table.n_slots : 1 + (k + 1) * table.n_slots].view(n_rows, 128)
                   for k in range(3))
    pairs = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    with pytest.raises(ValueError, match="aligned"):
        probe_cuda.probe_rows_async(planes, pairs, pairs, **kw)


def test_persisting_l2_limits_and_reset(cuda):
    from tokenizer_tpu_torch.ops import probe_cuda

    limits = probe_cuda.l2_limits(cuda)
    assert limits["max_persisting_l2_bytes"] > 0 and limits["max_access_policy_window_bytes"] > 0
    before = limits["persisting_l2_bytes"]
    # CUDA rounds a set-aside up to its own granularity (3,276,800 bytes
    # on an H100 80GB HBM3), so ask for one far from the current one.
    cap = limits["max_persisting_l2_bytes"]
    want = min(cap, (1 << 20) if before > cap // 2 else cap - (1 << 20))
    with probe_cuda.persisting_l2(want, cuda):
        now = probe_cuda.l2_limits(cuda)["persisting_l2_bytes"]
        assert want <= now <= cap and now != before
    assert probe_cuda.l2_limits(cuda)["persisting_l2_bytes"] == before


# -- the corpus path: one pinned upload per wave, encode_corpus ------------


def _forced_card(name: str):
    require_vocab(name)
    import tokenizer_tpu_torch as tt

    tok = tt.create_by_encoder_name(name, allow_fetch=False, device="cuda")
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    tok._ensure_device()  # the table's upload stays out of what is counted
    torch.cuda.synchronize()
    return tok


def test_device_wave_uploads_once_from_pinned_memory(cuda, lib_rs_text):
    """One forced device wave of several tiles: torch.profiler sees one
    host-to-device copy, from page-locked memory, and one copy back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tok = _forced_card("gpt2")
    texts = [lib_rs_text[:8000], "1" * 100 + " " + "x" * 40, "好" * 30]
    before = merge_cuda.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = tok.encode_batch(texts)
        torch.cuda.synchronize()
    assert tok.stats.device_waves == 1 and merge_cuda.LAUNCHES - before >= 3
    device_copies = sorted(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA and "Memcpy" in e.name
    )
    assert [n for n in device_copies if "HtoD" in n] == ["Memcpy HtoD (Pinned -> Device)"]
    assert len([n for n in device_copies if "DtoH" in n]) == 1
    import tokenizer_tpu_torch as tt

    ref = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu")
    assert [list(g) for g in got] == [ref.encode(t) for t in texts]


def test_encode_corpus_on_card_equals_host_reference(cuda, tmp_path, lib_rs_text):
    import sys

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.runtime.pipeline import encode_corpus
    from tokenizer_tpu_torch.runtime.profiler import ThroughputMeter

    rng = np.random.default_rng(17)
    text = lib_rs_text
    docs = []
    for k in range(60):
        s = int(rng.integers(0, len(text) - 3000))
        docs.append(text[s : s + int(rng.integers(200, 3000))] + f" zq{k}x {k * 7919}")
    tok = _forced_card("cl100k_synth")
    before = merge_cuda.LAUNCHES
    meter = ThroughputMeter()
    with meter:
        prog = encode_corpus(iter(docs), tok, tmp_path / "card", chunk_bytes=20000)
        meter.block_until_ready(tok._tabs[tok.device])
    assert merge_cuda.LAUNCHES > before and tok.stats.device_pieces > 0
    assert prog.chunks_done > 2 and prog.docs == len(docs)
    ref = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu")
    ref._host_wave_max = sys.maxsize
    ref_prog = encode_corpus(iter(docs), ref, tmp_path / "host", chunk_bytes=20000)
    assert ref.stats.device_pieces == 0
    assert (ref_prog.chunks_done, ref_prog.tokens_out) == (prog.chunks_done, prog.tokens_out)
    for f in sorted((tmp_path / "host").glob("*.npz")):
        a, b = np.load(f), np.load(tmp_path / "card" / f.name)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["offsets"], b["offsets"])


# -- the mesh: two shards of one card ------------------------------------------


def test_two_shards_of_one_card_equal_the_plain_merge(cuda, merge_table, lib_rs_text):
    """make_sharded_merge_fn over [cuda, cuda]: one launch per shard, each
    on its own stream; the gathered columns and the summed counters equal
    the plain merge of the whole tile."""
    from tokenizer_tpu_torch.parallel import data_mesh, gather_shards, make_sharded_merge_fn

    table = merge_table
    ids, lengths = _tile(table, lib_rs_text.encode(), 64, 2048, seed=31)
    mesh = data_mesh(devices=[cuda, cuda])
    fn = make_sharded_merge_fn(table, mesh)
    merge_cuda.STREAM_LAUNCHES.clear()
    before = merge_cuda.LAUNCHES
    out_ids, out_n, counters = fn(ids, lengths)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES == before + 2
    assert len(merge_cuda.STREAM_LAUNCHES) == 2 and set(merge_cuda.STREAM_LAUNCHES.values()) == {1}
    assert [tuple(o.shape) for o in out_ids] == [(64, 1024)] * 2
    got_ids, got_n = gather_shards(out_ids, out_n)
    kw = dict(slot_bits=table.slot_bits, max_probes=table.max_probes)
    p_ids, p_n = merge_packed_torch(
        device_table(table, cuda), torch.from_numpy(ids).to(cuda), torch.from_numpy(lengths).to(cuda), **kw
    )
    np.testing.assert_array_equal(got_ids, p_ids.cpu().numpy())
    np.testing.assert_array_equal(got_n, p_n.cpu().numpy())
    assert counters.cpu().tolist() == [int(p_n.sum()), int((lengths > 0).sum())]


def test_mesh_tokenizer_on_two_shards_of_one_card(cuda, lib_rs_text):
    """A GpuTokenizer over [cuda, cuda]: every wave to the shards, one
    upload per shard and wave, the kernel launched on both shard streams;
    ids equal the host-routed reference and, for gpt2, the golden."""
    import sys

    import tokenizer_tpu_torch as tt
    from tokenizer_tpu_torch.parallel import data_mesh

    require_vocab("cl100k_synth")
    mesh = data_mesh(devices=[cuda, cuda])
    gpt2 = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cuda", mesh=mesh)
    (ids,) = gpt2.encode_batch([lib_rs_text])
    assert list(ids) == json.loads(find_testdata("tokens_gpt2.json").read_text())
    rng = np.random.default_rng(23)
    docs = []
    for k in range(40):
        s = int(rng.integers(0, len(lib_rs_text) - 2000))
        docs.append(lib_rs_text[s : s + int(rng.integers(50, 2000))] + f" zq{k}x 好{k * 7919}")
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cuda", mesh=mesh)
    assert tok.mesh is mesh
    merge_cuda.STREAM_LAUNCHES.clear()
    got = tok.encode_batch(docs[:20])
    got += [g for b in tok.encode_batch_stream([docs[20:30], docs[30:]]) for g in b]
    torch.cuda.synchronize()
    ref = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu")
    ref._host_wave_max = sys.maxsize
    for d, g, w in zip(docs, got, ref.encode_batch(docs)):
        assert np.array_equal(g, w), repr(d[:60])
    st = tok.stats
    assert st.device_waves >= 3 and st.device_uploads == 2 * st.device_waves
    assert st.host_wave_pieces == 0
    shard_streams = {s.cuda_stream for s in tok._streams}
    assert len(shard_streams) == 2
    assert {stream for _, stream in merge_cuda.STREAM_LAUNCHES} == shard_streams


# -- parity on the card: tiktoken, and waves in flight --------------------------


@pytest.mark.parametrize("name", ["cl100k_synth", "o200k_synth"])
def test_synth_parity_on_card_vs_tiktoken(cuda, name, lib_rs_text):
    """A forced card tokenizer against Rust tiktoken built from the same ranks
    (tools/synth_goldens.py): encode_batch and a cold encode_batch_stream of
    gen_corpus(0.5, seed=31337) plus tests/test_torch_synth.py's micro corpus,
    specials with allowed_special="all", and the committed lib.rs.txt golden."""
    pytest.importorskip("tiktoken")
    sys.path.insert(0, str(REPO / "tools"))
    import synth_goldens
    from bench import gen_corpus
    from test_torch_synth import CORPUS

    rust = synth_goldens.rust_encoding(name)
    tok = _forced_card(name)
    docs = gen_corpus(0.5, seed=31337) + CORPUS
    before = merge_cuda.LAUNCHES
    out = tok.encode_batch(docs)
    for d, ids in zip(docs, out):
        assert list(ids) == rust.encode(d, disallowed_special=()), repr(d[:80])
    tok._reset_dedup_full()
    chunks = [docs[i : i + 40] for i in range(0, len(docs), 40)]
    flat = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    assert len(flat) == len(docs)
    for d, ids in zip(docs, flat):
        assert list(ids) == rust.encode(d, disallowed_special=()), repr(d[:80])
    texts = ["a<|endoftext|>b", "plain <|endofprompt|>", "<|endoftext|><|endoftext|>"]
    if name == "cl100k_synth":
        texts.append("<|fim_prefix|>head<|fim_suffix|>tail<|fim_middle|>mid")
    for t, ids in zip(texts, tok.encode_batch(texts, allowed_special="all")):
        assert list(ids) == rust.encode(t, allowed_special="all"), repr(t)
    tok._reset_dedup_full()
    (ids,) = tok.encode_batch([lib_rs_text])
    assert list(ids) == json.loads(find_testdata(f"tokens_{name}.json").read_text())
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES > before and tok.stats.host_wave_pieces == 0


@pytest.mark.parametrize("entry", ["batch", "stream"])
def test_long_pieces_merge_on_card_vs_tiktoken(cuda, entry, lib_rs_text):
    """gen_corpus documents with their CJK runs (each one piece of 600-1,797
    bytes) through a forced card tokenizer: ids equal to Rust tiktoken, no
    piece on the host fallback, and the merge kernel launched on tiles with
    L > 512 (the card's own buckets, gpu.DEVICE_BUCKETS), one launch a tile."""
    pytest.importorskip("tiktoken")
    sys.path.insert(0, str(REPO / "tools"))
    import synth_goldens
    from tokenizer_tpu_torch import gpu

    rust = synth_goldens.rust_encoding("cl100k_synth")
    tok = _forced_card("cl100k_synth")
    docs = chip_smoke.gen_corpus(0.5, 7, lib_rs_text)
    long = {b for d in docs for b in (p.encode() for p in tok._re.findall(d)) if len(b) > 512}
    assert long and max(map(len, long)) <= gpu.DEVICE_BUCKETS[-1] == merge_cuda.MAX_L
    tiles = []
    merge = tok._merge_fn

    def watch(tab, ids, lengths):
        tiles.append(int(ids.shape[0]))
        return merge(tab, ids, lengths)

    tok._merge_fn = watch
    before = merge_cuda.LAUNCHES
    if entry == "batch":
        out = tok.encode_batch(docs)
    else:
        out = [ids for b in tok.encode_batch_stream([docs[i : i + 16] for i in range(0, len(docs), 16)])
               for ids in b]
    torch.cuda.synchronize()
    for d, ids in zip(docs, out):
        assert list(ids) == rust.encode_ordinary(d), repr(d[:80])
    assert merge_cuda.LAUNCHES - before == len(tiles)
    assert {L for L in tiles if L > 512} == {L for L in gpu.DEVICE_BUCKETS if any(
        L // 2 < len(b) <= L for b in long)}
    assert tok.stats.host_fallback_pieces == 0 and tok.stats.device_long_pieces == len(long)


def test_default_router_scans_each_chunk_once_and_sends_long_pieces_to_k1(cuda, lib_rs_text):
    """The card's router at default routing, as ``chip_smoke.py`` phase 5
    checks it: a cold ``encode_batch_stream`` of gen_corpus documents (their
    CJK runs) in 64-document chunks makes one native split call a chunk,
    fuses the short first-seen pieces, leaves those over ``gpu.L_HOST`` to
    the chunk's wave, which merges on the host if it holds at most
    ``gpu.HOST_WAVE_MAX`` pieces and on K1 otherwise (``device_long_pieces``
    > 0, launches), merges each piece once, and its ids equal Rust
    tiktoken's."""
    pytest.importorskip("tiktoken")
    require_vocab("cl100k_synth")
    sys.path.insert(0, str(REPO / "tools"))
    import synth_goldens

    import tokenizer_tpu_torch as tt

    rust = synth_goldens.rust_encoding("cl100k_synth")
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cuda")
    docs = chip_smoke.gen_corpus(1.0, 3, lib_rs_text)
    chunks = [docs[i : i + 64] for i in range(0, len(docs), 64)]
    before = merge_cuda.LAUNCHES
    out = [ids for b in tok.encode_batch_stream(chunks) for ids in b]
    torch.cuda.synchronize()
    st = tok.stats.as_dict()
    assert st["scan_calls"] == len(chunks)
    assert st["device_long_pieces"] > 0 and merge_cuda.LAUNCHES > before
    assert st["fused_pieces"] > 0 and st["scan_defer_long"] > 0
    in_waves = st["host_wave_pieces"] - st["fused_pieces"]  # merged in host waves
    assert st["device_pieces"] > 0 and st["scan_defer_wide"] == 0
    assert st["device_pieces"] + in_waves == st["scan_defer_long"] + st["scan_defer_capacity"]
    assert st["scan_bpe_pieces"] == in_waves  # the host's batched merge took only those
    assert len(out) == len(docs)
    for d, ids in zip(docs, out):
        assert list(ids) == rust.encode_ordinary(d), repr(d[:80])


@pytest.mark.parametrize("case", list(chip_smoke.IN_FLIGHT))
def test_parity_in_flight_on_card(cuda, case):
    """chip_smoke.py phase 9 (c) on the card: each case's waves really are in
    flight while the host scans on, and its ids equal the host engine's."""
    import tokenizer_tpu_torch as tt

    require_vocab("cl100k_synth")
    host = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device=None)
    before = merge_cuda.LAUNCHES
    assert chip_smoke.IN_FLIGHT[case](cuda, host)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES > before


def test_a_wave_finishes_without_the_next_wave_s_kernels(cuda, lib_rs_text):
    """chip_smoke.py phase 3's readiness line: a short wave k dispatched
    before a wave of one ``[2048, 8192]`` tile of CJK runs finishes in a
    small fraction of that tile's K1 time (its copy back was queued behind
    its own launches, not behind the next wave's), with the plain merge's
    ids; the next wave's finish does wait for its K1."""
    tok = _forced_card("cl100k_synth")
    pool = chip_smoke.long_pieces(tok, chip_smoke.gen_corpus(1.0, 7, lib_rs_text))[2048]
    assert pool
    res = chip_smoke.readiness(tok, pool, np.random.default_rng(3))
    print(json.dumps(res))
    assert res["max_abs_err"] == 0
    assert res["finish_ms"] < chip_smoke.READY_SHARE * res["next_k1_ms"], res
    assert res["next_finish_ms"] > res["finish_ms"], res


# -- the benchmark's cells --------------------------------------------------------


@pytest.mark.parametrize("cell", ["cl100k_synth-corpus-64mb", "cl100k_synth-stream-8mb"])
def test_bench_cell_on_card(cuda, cell, tmp_path):
    """bench_torch.py's cell at its full size, one timed repetition: every
    document equals tiktoken's ids, and the device fields are measured
    from a complete trace (its busy time, idle share and transfers, K1's
    time in it) or, where the profiler dropped rows, all left unmeasured;
    peak memory and, for the stream, K1 alone per bucket always."""
    import bench_torch

    require_vocab("cl100k_synth")
    pytest.importorskip("tiktoken")
    card = {"card": chip_smoke.smi_line(), "kind": torch.cuda.get_device_name(cuda),
            "device_count": torch.cuda.device_count()}
    (rec,) = bench_torch.run([cell], 0, cuda, card, overrides={cell: {"repetitions": 1}},
                             work=tmp_path / "work")
    assert rec["mismatched_documents"] == 0 and rec["documents_checked"] > 0
    layers = rec["layers"]
    assert layers["device_waves"] > 0 and layers["k1_launches"] > 0
    assert layers["peak_device_bytes"] > 0 and 0 < layers["k1_rows"]
    if layers["device_trace_complete"]:
        assert layers["k1_rows"] == layers["k1_launches"]
        assert 0 < layers["device_busy_us"] < layers["window_us"]
        assert 0 < layers["device_idle_share"] < 1 and layers["k1_device_us"] > 0
        assert layers["h2d_copies_per_wave"] >= 1 and layers["d2h_copies_per_wave"] >= 1
        assert layers["top_device_ops"] and layers["longest_idle_gaps"]
    else:
        assert all(layers[k] is None for k in bench_torch.DEVICE_KEYS)
    if rec["cell"] == "cl100k_synth-stream-8mb":
        assert all(v > 0 for v in layers["k1_tile_us"].values())
        assert all(0 < v < 1 for v in layers["k1_tile_bound_share"].values())


@pytest.mark.parametrize("case", [c for c, f in bench_entries.CASES.items() if not f.get("mesh_devices")])
def test_bench_entry_on_card(cuda, case, tmp_path):
    """Each one-card case of tools/bench_entries.py (the bulk trims,
    decode, the rotation-active blend, the forced o200k_synth stream; the
    four-card stream has its own test below) at its full
    size, one timed repetition: every output checked, the waves of all but
    decode on the card (the forced stream's every wave), decode on the
    host only."""
    import bench_torch

    require_vocab(bench_entries.CASES[case].get("config", "cl100k_synth"))
    pytest.importorskip("tiktoken")
    card = {"card": chip_smoke.smi_line(), "kind": torch.cuda.get_device_name(cuda),
            "device_count": torch.cuda.device_count()}
    (rec,) = bench_torch.run([case], 0, cuda, card, bench=bench_entries.with_cases(
        bench_torch.load_benchmark(), 1), work=tmp_path / "work")
    assert rec["mismatched_documents"] == 0 and rec["documents_checked"] > 0
    (router,), layers = rec["router"], rec["layers"]
    if rec["entry"] == "decode_batch":
        assert layers["host_only"] and layers["k1_launches"] == router["device_waves"] == 0
        return
    assert layers["device_waves"] > 0 and layers["k1_launches"] > 0 and layers["peak_device_bytes"] > 0
    if "blend_copies" in rec["input"]:
        assert router["dedup_resets"] > 0
    if rec["routing"] == "forced":
        assert router["host_wave_pieces"] == router["fused_pieces"] == 0
        assert all(0 < v < 1 for v in layers["k1_tile_bound_share"].values())


#: The four-card stream's run, in a process of its own (argv: the repo, a
#: work directory): late in a long process, such as a whole run of this
#: file, torch.profiler dropped the cell's K1 rows from its trace.
MESH_RUN = r"""
import json, sys
from pathlib import Path
import torch
repo, work = sys.argv[1], Path(sys.argv[2])
sys.path[:0] = [repo, repo + "/tools"]
import bench_entries, bench_torch, chip_smoke
(mesh,) = [c for c, f in bench_entries.CASES.items() if f.get("mesh_devices")]
n = torch.cuda.device_count()
devices = [f"cuda:{i}" for i in range(4)] if n >= 4 else ["cuda:0"] * 4
cuda = torch.device("cuda", 0)
card = {"card": chip_smoke.smi_line(), "kind": torch.cuda.get_device_name(cuda), "device_count": n}
(rec,) = bench_torch.run([mesh], 0, cuda, card, work=work / "work",
                         bench=bench_entries.with_cases(bench_torch.load_benchmark(), 1),
                         overrides={mesh: {"mb": 1.0, "devices": devices}})
(work / "rec.json").write_text(json.dumps(rec))
"""


def test_bench_mesh_cell_on_card(cuda, tmp_path):
    """tools/bench_entries.py's four-card stream at 1 MB, one timed
    repetition, over every card where there are four, else over four
    shards of ``cuda:0`` (each its own stream, upload and fetch), traced in
    a process of its own (``MESH_RUN``): every document equals tiktoken's
    ids, every wave goes to the shards, the trace is complete card by
    card, and K1 launches on each shard's stream."""
    import subprocess

    require_vocab("cl100k_synth")
    pytest.importorskip("tiktoken")
    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(4)] if n >= 4 else ["cuda:0"] * 4
    run = subprocess.run([sys.executable, "-c", MESH_RUN, str(REPO), str(tmp_path)], cwd=str(REPO),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["mismatched_documents"] == 0 and rec["documents_checked"] > 0
    assert rec["shards"] == devices and len(rec["cards"]) == n
    layers = rec["layers"]
    assert layers["host_wave_pieces"] == layers["fused_pieces"] == 0 and layers["device_waves"] > 0
    assert all(r["host_wave_pieces"] == 0 for r in rec["router"])
    assert layers["device_trace_complete"] is True and layers["k1_rows"] == layers["k1_launches"]
    by_shard = layers["k1_launches_by_card"]
    assert len(by_shard) == 4 and all(k > 0 for k in by_shard) and sum(by_shard) == layers["k1_launches"]
    assert layers["h2d_copies_per_wave"] >= 4 and layers["d2h_copies_per_wave"] >= 4
    assert all(0 < b < layers["window_us"] for b in layers["device_busy_us_by_card"])
    assert all(0 < s < 1 for s in layers["device_idle_share_by_card"])
    assert all(b > 0 for b in layers["peak_device_bytes_by_card"])
    assert layers["peak_device_bytes"] == max(layers["peak_device_bytes_by_card"])
