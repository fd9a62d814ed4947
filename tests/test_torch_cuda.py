"""The CUDA kernels on the card vs their plain PyTorch versions, exactly.

Every test here needs an NVIDIA card with nvcc (``-m cuda``) and skips
without one; run them on the card with
``python -m pytest tests/test_torch_cuda.py -q``.  Tiles are made from a
seed with numpy and go through the kernel and the plain version on the
same device; int32 throughout, so the tolerance is zero.
"""

import json

import numpy as np
import pytest
import torch

from conftest import find_testdata, require_vocab

from tokenizer_tpu.ops.merge_numpy import merge_packed_numpy
from tokenizer_tpu.ops.packing import BUCKETS
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.ops.merge_torch import device_table, merge_packed_torch

pytestmark = pytest.mark.cuda


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
