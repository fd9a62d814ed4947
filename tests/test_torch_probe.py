"""The port's probe-experiment layouts and plain versions vs the JAX package, exactly.

The same numpy-made pairs go through the plain PyTorch versions of K3/K4
(``probe_rows_torch``) and K5 (``lookup_onehot_torch``), the JAX package's
Pallas kernels in interpret mode (``probe_pallas_dma``, ``probe_pallas_vmem``,
``lookup_onehot_pallas``) and ``PairTable.lookup``, on the real gpt2 table
and on cl100k_synth.  Everything is int32 or int8, so the tolerance is
zero.  The wrappers of :mod:`tokenizer_tpu_torch.ops.probe_cuda` take the
plain route on CPU tensors and count no launch.  K5's card-side pieces
that are plain Python are held here too: the K-major table its kernel
reads (``bigtable_kmajor``), the checks the wrapper makes on it
(``check_kmajor``) and the tiling its kernel walks (``onehot_tiling``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import require_vocab

from tokenizer_tpu.ops import exp_pallas_bigtable, exp_pallas_dma
from tokenizer_tpu.ops.pair_table import MAX_RANK
from tokenizer_tpu_torch.ops import exp_probe, probe_cuda
from tokenizer_tpu_torch.ops.exp_probe_torch import (
    bigtable_device_table,
    bigtable_kmajor,
    lookup_onehot_torch,
    probe_rows_torch,
    table_planes_2d,
)

NEAR = 2**31 - 1


@pytest.fixture(scope="module")
def cl100k_table():
    require_vocab("cl100k_synth")
    from tokenizer_tpu.vocab import Vocabulary

    return Vocabulary.for_encoding("cl100k_synth", allow_fetch=False).pair_table()


@pytest.fixture(scope="module")
def dma_probes(gpt2_pair_table):
    """The [8, 128] probe set of tests/test_exp_pallas_dma.py (seed 42)."""
    table = gpt2_pair_table
    rng = np.random.default_rng(42)
    n = 8 * 128
    filled = np.nonzero(table.key_left != -1)[0]
    pick = rng.choice(filled, size=n // 2)
    left = np.empty(n, np.int32)
    right = np.empty(n, np.int32)
    left[: n // 2] = table.key_left[pick]
    right[: n // 2] = table.key_right[pick]
    left[n // 2 :] = rng.integers(0, 50000, n // 2)
    right[n // 2 :] = rng.integers(0, 50000, n // 2)
    left[::37] = -1
    return left.reshape(8, 128), right.reshape(8, 128)


@pytest.fixture(scope="module")
def onehot_probes(gpt2_pair_table):
    """The [2, 128] probe set of tests/test_exp_pallas_bigtable.py (seed 5)."""
    table = gpt2_pair_table
    S, B = 2, 128
    rng = np.random.default_rng(5)
    pick = rng.integers(0, len(table.key_left), size=S * B)
    even = np.arange(S * B) % 2 == 0
    left = np.where(even, table.key_left[pick], rng.integers(0, 50257, size=S * B))
    right = np.where(even, table.key_right[pick], rng.integers(0, 50257, size=S * B))
    left = np.where(left < 0, 0, left).astype(np.int32).reshape(S, B)
    right = np.where(right < 0, 0, right).astype(np.int32).reshape(S, B)
    return left, right


def _kw(table):
    return dict(slot_bits=table.slot_bits, max_probes=table.max_probes)


def _rows(table, left, right):
    return probe_rows_torch(
        table_planes_2d(table, "cpu"),
        table.slot_bits,
        table.max_probes,
        torch.from_numpy(left),
        torch.from_numpy(right),
    ).numpy()


def _onehot(table, left, right):
    return lookup_onehot_torch(
        bigtable_device_table(table, "cpu"),
        torch.from_numpy(left),
        torch.from_numpy(right),
        **_kw(table),
    ).numpy()


# -- layouts ----------------------------------------------------------------


def test_table_planes_2d_bit_equal_to_jax(gpt2_pair_table):
    table = gpt2_pair_table
    jax_planes = exp_pallas_dma.table_planes_2d(table)
    ours = table_planes_2d(table, "cpu")
    from_jax = table_planes_2d(tuple(np.asarray(p) for p in jax_planes), "cpu")
    for mine, theirs, again in zip(ours, jax_planes, from_jax):
        assert mine.dtype == torch.int32 and mine.shape == (table.n_slots // 128, 128)
        assert mine.is_contiguous()
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        assert torch.equal(mine, again)
    # One buffer: the planes follow each other, as K4's L2 window assumes.
    plane_bytes = table.n_slots * 4
    assert ours[1].data_ptr() - ours[0].data_ptr() == plane_bytes
    assert ours[2].data_ptr() - ours[1].data_ptr() == plane_bytes


@pytest.mark.parametrize("vocab", ["gpt2", "cl100k_synth"])
def test_bigtable_device_table_bit_equal_to_jax(request, vocab):
    table = request.getfixturevalue("gpt2_pair_table" if vocab == "gpt2" else "cl100k_table")
    got = bigtable_device_table(table, "cpu")
    want = exp_pallas_bigtable.bigtable_device_table(table)
    assert got.dtype == torch.int8 and got.shape == (4, table.n_slots // 128, 384)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab", ["gpt2", "cl100k_synth"])
def test_bigtable_kmajor_bit_equal_to_jax_transposed(request, vocab):
    table = request.getfixturevalue("gpt2_pair_table" if vocab == "gpt2" else "cl100k_table")
    n_rows = table.n_slots // 128
    got = bigtable_kmajor(bigtable_device_table(table, "cpu"))
    want = np.transpose(exp_pallas_bigtable.bigtable_device_table(table), (0, 2, 1))
    assert got.dtype == torch.int8 and got.shape == (4 * 384, n_rows) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.reshape(4 * 384, n_rows))
    assert probe_cuda.check_kmajor(got, table.slot_bits, "cpu") == n_rows


# -- plain versions vs the Pallas kernels (interpret mode) -------------------


@pytest.mark.parametrize("mode", ["vmem", "dma"])
def test_probe_rows_torch_matches_pallas_interpret(gpt2_pair_table, dma_probes, mode):
    table = gpt2_pair_table
    left, right = dma_probes
    fn = exp_pallas_dma.probe_pallas_vmem if mode == "vmem" else exp_pallas_dma.probe_pallas_dma
    pallas = np.asarray(
        fn(exp_pallas_dma.table_planes_2d(table), table.slot_bits, table.max_probes,
           left, right, interpret=True)
    )
    got = _rows(table, left, right)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, table.lookup(left, right))
    assert (got[left < 0] == MAX_RANK).all()


def test_lookup_onehot_torch_matches_pallas_interpret(gpt2_pair_table, onehot_probes):
    table = gpt2_pair_table
    left, right = onehot_probes
    pallas = np.asarray(
        exp_pallas_bigtable.lookup_onehot_pallas(
            jnp.asarray(exp_pallas_bigtable.bigtable_device_table(table)),
            jnp.asarray(left),
            jnp.asarray(right),
            interpret=True,
            **_kw(table),
        )
    )
    got = _onehot(table, left, right)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, table.lookup(left, right))


@pytest.mark.parametrize("plain", ["probe_rows", "lookup_onehot"])
def test_plain_versions_match_pair_table_cl100k_synth(cl100k_table, plain):
    table = cl100k_table
    left, right = exp_probe.make_probes(table, (4, 128), seed=3)
    want = table.lookup(left, right)
    got = (_rows if plain == "probe_rows" else _onehot)(table, left, right)
    np.testing.assert_array_equal(got, want)
    assert (got != MAX_RANK).sum() >= 200  # half the pairs are keys of the table


# -- edges --------------------------------------------------------------------


@pytest.mark.parametrize("plain", ["probe_rows", "lookup_onehot"])
def test_extreme_and_negative_ids(gpt2_pair_table, plain):
    table = gpt2_pair_table
    keys = np.nonzero(table.key_left >= 0)[0][:120]
    left = np.full((1, 128), 5, np.int32)
    right = np.full((1, 128), 7, np.int32)
    left[0, :120], right[0, :120] = table.key_left[keys], table.key_right[keys]
    left[0, 120:] = [NEAR, NEAR - 1, -1, -7, 0, NEAR, -(2**31), 300]
    right[0, 120:] = [NEAR, 17, 5, 3, NEAR - 2, 0, 1, NEAR]
    got = (_rows if plain == "probe_rows" else _onehot)(table, left, right)
    np.testing.assert_array_equal(got, table.lookup(left, right))
    np.testing.assert_array_equal(got[0, :120], table.values[keys])
    assert (got[0, 120:] == MAX_RANK).all()


def test_empty_input(gpt2_pair_table):
    table = gpt2_pair_table
    empty = torch.zeros((0, 128), dtype=torch.int32)
    planes = table_planes_2d(table, "cpu")
    tab8 = bigtable_device_table(table, "cpu")
    assert probe_rows_torch(planes, table.slot_bits, table.max_probes, empty, empty).shape == (0, 128)
    assert lookup_onehot_torch(tab8, empty, empty, **_kw(table)).shape == (0, 128)
    for fn in (probe_cuda.probe_rows_async, probe_cuda.probe_rows_resident):
        assert fn(planes, empty, empty, **_kw(table)).shape == (0, 128)
    assert probe_cuda.lookup_onehot(tab8, empty, empty, **_kw(table)).shape == (0, 128)


# -- the wrappers ---------------------------------------------------------------


def test_wrappers_cpu_route_is_plain_and_launches_nothing(gpt2_pair_table, monkeypatch):
    table = gpt2_pair_table
    left, right = (torch.from_numpy(a) for a in exp_probe.make_probes(table, (2, 128), seed=9))
    want = table.lookup(left.numpy(), right.numpy())
    calls = []

    def counting(real):
        def fn(*a, **k):
            calls.append(real.__name__)
            return real(*a, **k)

        return fn

    monkeypatch.setattr(probe_cuda, "probe_rows_torch", counting(probe_rows_torch))
    monkeypatch.setattr(probe_cuda, "lookup_onehot_torch", counting(lookup_onehot_torch))
    counts = (probe_cuda.ASYNC_LAUNCHES, probe_cuda.RESIDENT_LAUNCHES, probe_cuda.ONEHOT_LAUNCHES)
    planes = table_planes_2d(table, "cpu")
    for fn in (probe_cuda.probe_rows_async, probe_cuda.probe_rows_resident):
        np.testing.assert_array_equal(fn(planes, left, right, **_kw(table)).numpy(), want)
    got = probe_cuda.lookup_onehot(bigtable_device_table(table, "cpu"), left, right, **_kw(table))
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == ["probe_rows_torch", "probe_rows_torch", "lookup_onehot_torch"]
    assert counts == (
        probe_cuda.ASYNC_LAUNCHES, probe_cuda.RESIDENT_LAUNCHES, probe_cuda.ONEHOT_LAUNCHES
    )


def test_wrappers_reject_bad_operands(gpt2_pair_table):
    table = gpt2_pair_table
    kw = _kw(table)
    planes = table_planes_2d(table, "cpu")
    tab8 = bigtable_device_table(table, "cpu")
    pairs = torch.zeros((2, 128), dtype=torch.int32)
    rows = (probe_cuda.probe_rows_async, probe_cuda.probe_rows_resident)
    for fn in rows:
        with pytest.raises(TypeError, match="int32"):
            fn(planes, pairs.long(), pairs, **kw)
        with pytest.raises(ValueError, match="differ in shape"):
            fn(planes, pairs, pairs[:1], **kw)
        with pytest.raises(ValueError, match="contiguous"):
            fn(planes, pairs.t(), pairs.t(), **kw)
        with pytest.raises(ValueError, match="3 planes"):
            fn(planes[:2], pairs, pairs, **kw)
        with pytest.raises(ValueError, match="shape"):
            fn(tuple(p.reshape(-1, 256) for p in planes), pairs, pairs, **kw)
        with pytest.raises(ValueError, match="shape"):
            fn(planes, pairs, pairs, slot_bits=table.slot_bits + 1, max_probes=table.max_probes)
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(planes, pairs.to("meta"), pairs.to("meta"), **kw)
    with pytest.raises(TypeError, match="int8"):
        probe_cuda.lookup_onehot(tab8.to(torch.int32), pairs, pairs, **kw)
    with pytest.raises(ValueError, match=r"\[S, 128\]"):
        probe_cuda.lookup_onehot(tab8, pairs.reshape(4, 64), pairs.reshape(4, 64), **kw)
    with pytest.raises(ValueError, match="n_rows"):
        probe_cuda.lookup_onehot(tab8[:, :-16].contiguous(), pairs, pairs, **kw)
    with pytest.raises(ValueError, match="n_rows"):
        probe_cuda.lookup_onehot(tab8, pairs, pairs, slot_bits=table.slot_bits - 1,
                                 max_probes=table.max_probes)
    with pytest.raises(ValueError, match=r"\[4, n_rows, 384\]"):
        probe_cuda.lookup_onehot(tab8[:3], pairs, pairs, **kw)
    with pytest.raises(ValueError, match="expected"):
        probe_cuda.lookup_onehot(tab8.to("meta"), pairs, pairs, **kw)


def _misaligned(tab_k):
    flat = torch.empty(tab_k.numel() + 1, dtype=torch.int8)
    out = flat[1:].view(tab_k.shape)
    out.copy_(tab_k)
    return out


@pytest.mark.parametrize(
    "case,err,match",
    [
        ("int32", TypeError, "int8"),
        ("jax layout", ValueError, r"\[1536, n_rows\]"),
        ("rows cut", ValueError, r"\[1536, n_rows\]"),
        ("slot_bits", ValueError, "n_rows"),
        ("device", ValueError, "expected"),
        ("strided", ValueError, "contiguous"),
        ("misaligned", ValueError, "aligned"),
    ],
)
def test_check_kmajor_rejects_a_bad_prepared_table(gpt2_pair_table, case, err, match):
    """What the wrapper refuses before it launches K5's kernel."""
    table = gpt2_pair_table
    tab8 = bigtable_device_table(table, "cpu")
    tab_k = bigtable_kmajor(tab8)
    sb, device = table.slot_bits, "cpu"
    bad = {
        "int32": lambda: tab_k.to(torch.int32),
        "jax layout": lambda: tab8,
        "rows cut": lambda: tab_k[:-1].contiguous(),
        "device": lambda: tab_k.to("meta"),
        "strided": lambda: tab_k.t().contiguous().t(),
        "misaligned": lambda: _misaligned(tab_k),
    }.get(case, lambda: tab_k)()
    if case == "slot_bits":
        sb += 1
    with pytest.raises(err, match=match):
        probe_cuda.check_kmajor(bad, sb, device)


@pytest.mark.parametrize("S", [1, 3, 16, 17])
@pytest.mark.parametrize("max_probes,n_rows", [(9, 4096), (12, 8192), (12, 16384)])
def test_onehot_tiling_covers_every_pair_round_once(S, max_probes, n_rows):
    """Over every CTA's walk, the epilogues write each scratch byte exactly
    once; padded rows are never written; the CTAs in flight share N-tiles."""
    t = probe_cuda.onehot_tiling(S, max_probes, n_rows)
    assert t.m_rows == S * 128 * max_probes and t.scratch_shape == (3, max_probes, S * 128)
    assert (t.m_tiles - 1) * 256 < t.m_rows <= t.m_tiles * 256
    assert t.tiles == 12 * t.m_tiles and t.k_tiles == n_rows // 128
    assert t.l2_to_smem_bytes == t.m_tiles * 4 * 384 * n_rows  # ceil(M / 256) tables
    grid = t.grid(132)
    assert grid == min(132, t.tiles)
    walked = [tile for cta in range(grid) for tile in t.cta_tiles(cta, grid)]
    assert sorted(walked) == list(range(t.tiles))
    written = np.concatenate([t.written_bytes(tile) for tile in walked])
    np.testing.assert_array_equal(np.sort(written), np.arange(3 * max_probes * S * 128 * 4))
    padded = t.m_tiles * 256 - t.m_rows
    rnd, pair = t.rows(t.m_tiles - 1)
    assert rnd.size == 256 - padded and rnd.max() < max_probes and pair.max() < S * 128
    # One wave of CTAs spans at most two N-tiles of B.
    first = {t.tile(tile)[1] for tile in range(grid)}
    assert max(first) - min(first) <= 1 + grid // t.m_tiles


def test_plain_k5_matches_pair_table_o200k_synth_at_one_row():
    require_vocab("o200k_synth")
    from tokenizer_tpu.vocab import Vocabulary

    table = Vocabulary.for_encoding("o200k_synth", allow_fetch=False).pair_table()
    assert table.slot_bits == 21
    left, right = exp_probe.make_probes(table, (1, 128), seed=11)
    got = _onehot(table, left, right)
    np.testing.assert_array_equal(got, table.lookup(left, right))
    assert (got != MAX_RANK).sum() >= 50


# -- the runner's arms on the CPU ------------------------------------------------


def test_make_probes_mixes_hits_misses_and_invalid(gpt2_pair_table):
    table = gpt2_pair_table
    left, right = exp_probe.make_probes(table, (4, 128), seed=1)
    assert left.shape == right.shape == (4, 128) and left.dtype == np.int32
    flat = left.reshape(-1)
    assert (flat[::37] == -1).all()
    hits = table.lookup(left, right) != MAX_RANK
    assert hits.reshape(-1)[:256].sum() >= 240  # the first half are keys
    l2, r2 = exp_probe.make_probes(table, (4, 128), seed=1)
    assert np.array_equal(left, l2) and np.array_equal(right, r2)


def test_run_arms_on_cpu_checks_plain_versions_only(gpt2_pair_table):
    recs = exp_probe.run_arms(gpt2_pair_table, "cpu", (2, 128))
    assert [r["arm"] for r in recs] == [a for a, _s, _r in exp_probe.ARMS]
    for r in recs:
        assert r["plain_bit_exact"] is True
        assert "ms" not in r and "bit_exact" not in r  # nothing timed or launched off the card


def test_runner_refuses_cuda_without_a_card_and_runs_plain_on_cpu(monkeypatch, capsys):
    import importlib.util
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "exp_cuda_probe.py"
    spec = importlib.util.spec_from_file_location("exp_cuda_probe", path)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        runner.main(["--table", "gpt2"])
    assert runner.main(["--table", "gpt2", "--device", "cpu", "--tile", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["table_slots"] == 2**19 and lines[0]["probe_shape"] == [1, 128]
    assert [x["arm"] for x in lines[1:]] == [a for a, _s, _r in exp_probe.ARMS]
    assert all(x["plain_bit_exact"] for x in lines[1:])


# -- K3's and K4's window plan ---------------------------------------------------


def dense_table():
    """128 slots holding 124 keys: chains run through several 16-round
    passes of K3 and K4 and wrap past the last slot."""
    from tokenizer_tpu.ops.pair_table import PairTable

    rng = np.random.default_rng(8)
    left = rng.integers(0, 1000, 124).astype(np.int32)
    right = rng.integers(0, 1000, 124).astype(np.int32) * 1000 + np.arange(124, dtype=np.int32)
    kl, kr, vv, mp = PairTable._insert_all(left, right, np.arange(124, dtype=np.int32) + 5, 7)
    assert mp > 2 * probe_cuda.PASS_ROUNDS
    return PairTable(key_left=kl, key_right=kr, values=vv, slot_bits=7, max_probes=mp,
                     byte_to_id=np.arange(256, dtype=np.int32), n_vocab=1000,
                     max_token_len=1, n_pairs=124)


@pytest.fixture(scope="module", params=["gpt2", "cl100k_synth", "o200k_synth", "dense"])
def window_table(request):
    """The three tables the port serves, and the dense 128-slot table."""
    if request.param == "dense":
        return dense_table()
    require_vocab(request.param)
    from tokenizer_tpu.vocab import Vocabulary

    return Vocabulary.for_encoding(request.param, allow_fetch=False).pair_table()


def _window_pairs(table):
    """A make_probes tile (hits, misses, negatives), keys homed in the
    plane's first and last row, and random pairs (misses, mostly) homed
    in the last 16 slots, whose chains wrap, or in the first 4."""
    n = table.n_slots
    left, right = (a.reshape(-1) for a in exp_probe.make_probes(table, (2, 128), seed=4))
    keys = np.nonzero(table.key_left >= 0)[0]
    k_home = probe_cuda.pair_homes(table.key_left[keys], table.key_right[keys], table.slot_bits)
    ends = keys[(k_home < 128) | (k_home >= n - 128)][:40]
    rng = np.random.default_rng(12)
    cand_l = rng.integers(0, max(table.n_vocab, 2), 1 << 20).astype(np.int32)
    cand_r = rng.integers(0, max(table.n_vocab, 2), 1 << 20).astype(np.int32)
    home = probe_cuda.pair_homes(cand_l, cand_r, table.slot_bits)
    wrap = np.nonzero(home >= n - 16)[0][:40]
    low = np.nonzero(home < 4)[0][:8]
    assert wrap.size >= 4 and low.size >= 1 and ends.size >= 4
    return (np.concatenate([left, table.key_left[ends], cand_l[wrap], cand_l[low]]),
            np.concatenate([right, table.key_right[ends], cand_r[wrap], cand_r[low]]))


def _answer_from_windows(table, w, left, right):
    """A numpy model of K3: each pass reads only the pair's windows of the
    three planes, walking its rounds in order; any read outside the
    spans fails.  Returns the ids and the passes each pair took."""
    planes = (table.key_left, table.key_right, table.values)
    out = np.full(left.shape, MAX_RANK, np.int32)
    live = w.homes >= 0
    taken = np.zeros(left.shape, np.int64)
    cols = np.arange(probe_cuda.WINDOW_SLOTS)
    for k in range(w.passes):
        starts, lengths, off = w.spans(k)
        taken += live
        held = lengths.sum(1)
        assert (held[live] > 0).all()
        # the window: the first span, then the second from slot 0
        slot = np.where(cols < lengths[:, :1], starts[:, :1] + cols, cols - lengths[:, :1])
        inside = cols < held[:, None]
        win = [np.where(inside, p[np.where(inside, slot, 0)], -99) for p in planes]
        rows = np.arange(left.size)
        for j in range(w.rounds(k)):
            col = off + j
            assert (col[live] < held[live]).all(), "a round outside the window"
            kl, kr, vv = (x[rows, np.minimum(col, probe_cuda.WINDOW_SLOTS - 1)] for x in win)
            hit = live & (kl == left) & (kr == right)
            out[hit] = vv[hit]
            live = live & (kl != -1) & ~hit
    return out, taken


@pytest.mark.parametrize("extra", [0, 20])
def test_windows_cover_every_chain_slot_once(window_table, extra):
    """Every slot of every pass's rounds lies in exactly one of the pair's
    spans; spans start 16-byte aligned, lie inside the plane, and hold at
    most WINDOW_SLOTS; the bytes are the spans' sum over pairs."""
    table = window_table
    n, mp = table.n_slots, table.max_probes + extra
    left, right = _window_pairs(table)
    hand = [0, 3, n - 1, n - mp + 1, n - 4]  # where the chain starts or ends at an edge
    homes = np.concatenate([probe_cuda.pair_homes(left, right, table.slot_bits), hand])
    w = probe_cuda.probe_windows(homes, mp, table.slot_bits)
    valid = w.homes >= 0
    assert w.passes == -(-mp // 16) and (~valid).sum() >= 5
    total = 0
    for k in range(w.passes):
        starts, lengths, off = w.spans(k)
        assert (starts % 4 == 0).all() and (lengths % 4 == 0).all()
        assert (starts + lengths <= n).all() and (starts[:, 1] == 0).all()
        assert (lengths.sum(1) <= probe_cuda.WINDOW_SLOTS).all()
        assert (lengths[~valid] == 0).all() and (off < 4).all()
        rounds = (w.homes[:, None] + k * 16 + np.arange(w.rounds(k))) % n
        inside = [(rounds >= starts[:, s : s + 1]) & (rounds < (starts + lengths)[:, s : s + 1])
                  for s in (0, 1)]
        assert ((inside[0].astype(int) + inside[1])[valid] == 1).all()
        # round j sits at offset + j of the spans laid end to end
        at = off[:, None] + np.arange(w.rounds(k))
        back = np.where(at < lengths[:, :1], starts[:, :1] + at, at - lengths[:, :1])
        np.testing.assert_array_equal(back[valid], rounds[valid])
        total += 12 * int(lengths.sum())
    assert w.bytes == total
    if mp <= 16:
        assert w.bytes <= valid.sum() * probe_cuda.PASS_BYTES


@pytest.mark.parametrize("extra", [0, 20])
def test_answers_from_windows_alone_equal_the_lookup(window_table, extra):
    """The numpy model that reads only the windows equals PairTable.lookup
    and probe_rows_torch at the same max_probes, on make_probes pairs and
    on chains that start at the plane's ends and wrap."""
    import dataclasses

    table = dataclasses.replace(window_table, max_probes=window_table.max_probes + extra)
    left, right = _window_pairs(table)
    w = probe_cuda.probe_windows(probe_cuda.pair_homes(left, right, table.slot_bits),
                                 table.max_probes, table.slot_bits)
    got, taken = _answer_from_windows(table, w, left, right)
    np.testing.assert_array_equal(got, table.lookup(left, right))
    np.testing.assert_array_equal(got, _rows(table, left, right))
    assert (got != MAX_RANK).sum() >= 100 and taken.max() <= w.passes
    if table.slot_bits == 7:  # the dense table: chains run through several passes
        assert taken.max() >= 3


def test_probe_windows_rejects_bad_plans():
    for homes, mp, sb in (([0], 0, 19), ([0], 9, 6), ([0], 9, 32), ([-2], 9, 19), ([1 << 19], 9, 19)):
        with pytest.raises(ValueError):
            probe_cuda.probe_windows(homes, mp, sb)
    w = probe_cuda.probe_windows([0, -1, (1 << 19) - 1], 9, 19)
    # home 0: slots 0-8 in one 12-slot span; -1: nothing; n - 1: slots n-4..n-1,
    # then 0-7 from slot 0
    assert w.bytes == 12 * (12 + 4 + 8) and w.passes == 1
