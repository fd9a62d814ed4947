"""The span route's native packer and each wave's own copy back, on the CPU.

``ops.wave_pack.plan_spans`` + ``pack_wave`` (the native
``tt_pack_span_tiles``) must lay a span wave out exactly as
``ops.packing.pack_spans`` followed by ``parallel.encode_step.dispatch_shards``'
copy loop did: the same plan as the port's and the JAX package's
``pack_spans``, and the same int32 upload buffer, bit for bit, over every
bucket of ``gpu.DEVICE_BUCKETS``, on one shard and on eight (the mesh
quantum).  ``GpuTokenizer._bucket_out`` now reads the copies that
``queue_fetch`` queued at dispatch; it must return the arrays the
finish-time ``fetch_shards`` returned.  Everything is int32 or int64, so
every comparison is exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import require_vocab
from torch_cpu import forced, one_torch_thread  # noqa: F401  (autouse fixture)

import tokenizer_tpu_torch as tt
from tokenizer_tpu.ops import packing as jax_packing
from tokenizer_tpu_torch.gpu import DEVICE_BUCKETS
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.ops import packing as port_packing
from tokenizer_tpu_torch.ops.merge_cuda import LANE
from tokenizer_tpu_torch.ops.packing import MAX_B
from tokenizer_tpu_torch.ops.wave_pack import pack_wave, plan_spans
from tokenizer_tpu_torch.parallel import data_mesh
from tokenizer_tpu_torch.parallel.encode_step import dispatch_shards, wave_buffer
from tokenizer_tpu_torch.runtime import native

CPU = torch.device("cpu")
#: the lengths around every bucket's edge, and past the widest.
EDGES = (0, 1, 2, 16, 17, 512, 513, 1024, 1025, 2048, 2049)
SHARDS = (1, 8)


def _wave(rng, lens):
    """Spans of ``lens`` bytes at random places in one random buffer, the
    last ending at its last byte."""
    lens = np.asarray(lens, np.int64)
    size = max(4096, 2 * int(lens.max(initial=0)))
    buf = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    starts = np.array([rng.integers(0, size - n + 1) for n in lens], np.int64)
    starts[-1] = size - lens[-1]
    return buf, starts, starts + lens


def _lengths(kind: str, rng) -> list:
    if kind == "edges":
        lens = [n for n in EDGES for _ in range(3)]
        lens += rng.integers(0, 2100, 200).tolist()
        rng.shuffle(lens)
        return lens + [2048]
    if kind == "every_bucket":
        lens, prev = [], 1
        for L in DEVICE_BUCKETS:
            lens += rng.integers(prev + 1, L + 1, int(rng.integers(1, 300))).tolist()
            prev = L
        rng.shuffle(lens)
        return lens + [0, 1, 17]
    # more than MAX_B pieces of the 16-byte bucket, with a few others
    lens = rng.integers(2, 17, MAX_B + 777).tolist() + [1, 0, 600, 1500, 2049]
    rng.shuffle(lens)
    return lens


def _copy_loop_buffer(tiles, n: int) -> np.ndarray:
    """The upload buffer that ``dispatch_shards``' copy loop lays out for
    ``PackedBatch`` tiles over ``n`` CPU shards (no merge runs)."""
    _outs, host = dispatch_shards(
        [(b.ids, b.lengths) for b in tiles], [CPU] * n, [None] * n, {CPU: None},
        lambda tab, ids, lengths: (ids, lengths),
    )
    return host.numpy()


def _native_buffer(buf, starts, ends, b2i, plan, n: int) -> np.ndarray:
    out = wave_buffer([t.shape for t in plan.batches], n, False).numpy()
    pack_wave(buf, starts, ends, b2i, plan, n, out)
    return out


def _same_plan(plan, ref) -> None:
    """``plan`` (SpanTile batches) routes as ``ref`` (a ``pack_spans`` plan)."""
    assert [(t.l_max, t.shape, t.n_real) for t in plan.batches] == [
        (b.l_max, b.ids.shape, b.n_real) for b in ref.batches
    ]
    assert len(plan.batch_piece_idx) == len(ref.batch_piece_idx)
    for got, want in zip(plan.batch_piece_idx, ref.batch_piece_idx):
        np.testing.assert_array_equal(got, want)
    for field in ("direct_idx", "direct_ids", "host_idx"):
        got, want = getattr(plan, field), getattr(ref, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("kind", ["edges", "every_bucket", "over_max_b"])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_pack_equals_pack_spans_and_the_copy_loop(seed, kind, n):
    rng = np.random.default_rng(100 * seed + len(kind) + n)
    buf, starts, ends = _wave(rng, _lengths(kind, rng))
    b2i = rng.permutation(200_000)[:256].astype(np.int32)
    kw = dict(buckets=DEVICE_BUCKETS, b_quantum=LANE * n)
    plan = plan_spans(buf, starts, ends, b2i, **kw)
    port = port_packing.pack_spans(buf, starts, ends, b2i, **kw)
    jax_plan = jax_packing.pack_spans(buf, starts, ends, b2i, **kw)
    _same_plan(plan, port)
    _same_plan(plan, jax_plan)
    got = _native_buffer(buf, starts, ends, b2i, plan, n)
    want = _copy_loop_buffer(port.batches, n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _copy_loop_buffer(jax_plan.batches, n))
    assert {t.l_max for t in plan.batches} >= ({16} if kind == "over_max_b" else set(DEVICE_BUCKETS))
    if kind == "over_max_b":
        assert sum(t.l_max == 16 for t in plan.batches) == 2
    if kind == "edges":
        assert plan.host_idx.size > 0 and plan.direct_idx.size > 0


@pytest.mark.parametrize("n", SHARDS)
def test_native_pack_of_a_wave_with_no_tile(n):
    """Only direct and host pieces: no tile, an empty buffer, the same plan."""
    rng = np.random.default_rng(5)
    buf, starts, ends = _wave(rng, [0, 1, 1, 2049, 3000])
    b2i = np.arange(256, dtype=np.int32)
    plan = plan_spans(buf, starts, ends, b2i, buckets=DEVICE_BUCKETS, b_quantum=LANE * n)
    _same_plan(plan, port_packing.pack_spans(buf, starts, ends, b2i, buckets=DEVICE_BUCKETS,
                                             b_quantum=LANE * n))
    assert not plan.batches
    assert _native_buffer(buf, starts, ends, b2i, plan, n).size == 0


def test_native_pack_refuses_a_plan_that_does_not_fit():
    rng = np.random.default_rng(9)
    buf, starts, ends = _wave(rng, [5, 20, 40])
    b2i = np.arange(256, dtype=np.int32)
    plan = plan_spans(buf, starts, ends, b2i, buckets=DEVICE_BUCKETS)
    out = wave_buffer([t.shape for t in plan.batches], 1, False).numpy()
    with pytest.raises(ValueError, match="piece or span"):
        native.pack_span_tiles(buf, starts, ends + len(buf), b2i, np.array([[16, 128, 1], [64, 128, 2]]),
                               np.concatenate(plan.batch_piece_idx), 1, out)
    with pytest.raises(ValueError, match="piece or span"):  # a 40-byte piece in a 16-row tile
        native.pack_span_tiles(buf, starts, ends, b2i, np.array([[16, 128, 1], [16, 128, 2]]),
                               np.concatenate(plan.batch_piece_idx), 1,
                               np.empty(2 * (16 * 128 + 128), np.int32))
    with pytest.raises(ValueError, match="buffer's size"):
        native.pack_span_tiles(buf, starts, ends, b2i, np.array([[16, 128, 1], [64, 128, 2]]),
                               np.concatenate(plan.batch_piece_idx), 1, out[:-1])
    with pytest.raises(ValueError, match="buffer's size"):  # 128 columns do not split in 3
        native.pack_span_tiles(buf, starts, ends, b2i, np.array([[16, 128, 1], [64, 128, 2]]),
                               np.concatenate(plan.batch_piece_idx), 3, out)


class _WithoutPacker:
    """The loaded library, less ``tt_pack_span_tiles``."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name == "tt_pack_span_tiles":
            raise AttributeError(name)
        return getattr(self._lib, name)


def test_span_route_raises_without_the_native_packer(monkeypatch):
    """No other packer stands in: the forced device route raises before any
    launch when the library lacks the entry point."""
    require_vocab("gpt2")
    tok = forced(tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu"))
    lib = native._load()
    assert lib is not None
    monkeypatch.setattr(native, "_load", lambda: _WithoutPacker(lib))
    before = merge_cuda.LAUNCHES
    calls = []
    monkeypatch.setattr(merge_cuda, "merge_packed_torch", lambda *a, **k: calls.append(a))
    with pytest.raises(RuntimeError, match="tt_pack_span_tiles"):
        tok.encode_batch(["some fresh words for the device route " * 3])
    assert not calls and merge_cuda.LAUNCHES == before
    assert tok.stats.device_waves == 0


# -- each wave's own copy back ---------------------------------------------------


def _fetch_shards_as_before(outs, n_tiles: int, n: int):
    """The finish-time ``fetch_shards`` the port had before each wave queued
    its own copy back (its CPU path): one ``torch.cat`` a shard, then each
    tile's shards side by side."""
    shards = []
    for k in range(n):
        part = outs[k * n_tiles : (k + 1) * n_tiles]
        shards.append(torch.cat([o.reshape(-1) for o, _ in part] + [c for _, c in part]).cpu().numpy())
    tiles, off = [], 0
    for o, _ in outs[:n_tiles]:
        L, bs = o.shape
        tiles.append(
            np.concatenate([s[off : off + L * bs].reshape(L, bs) for s in shards], axis=1)
            if n > 1
            else shards[0][off : off + L * bs].reshape(L, bs)
        )
        off += L * bs
    out = []
    for ids, (_, c) in zip(tiles, outs[:n_tiles]):
        bs = c.shape[0]
        out.append((ids, np.concatenate([s[off : off + bs] for s in shards])))
        off += bs
    return out


def _tok(n: int):
    require_vocab("gpt2")
    mesh = data_mesh(devices=["cpu"] * n) if n > 1 else None
    return forced(tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu", mesh=mesh))


def _tiles(tok, n: int, rng):
    """Three tiles of ``n`` shards' quantum: [16, B], [64, 2B], [1024, B],
    short lowercase pieces, some columns empty."""
    B = LANE * n
    tiles = []
    for L, width in ((16, B), (64, 2 * B), (1024, B)):
        ids = np.full((L, width), -1, np.int32)
        lengths = rng.integers(0, min(L, 40) + 1, width).astype(np.int32)
        for c, m in enumerate(lengths):
            ids[:m, c] = tok.table.byte_to_id[rng.integers(97, 123, m)]
        tiles.append(SimpleNamespace(ids=ids, lengths=lengths, n_real=width))
    return tiles


@pytest.mark.parametrize("route", ["tiles", "spans"])
@pytest.mark.parametrize("n", SHARDS)
def test_bucket_out_reads_what_fetch_shards_did(route, n):
    """One device and eight ``cpu`` shards, the bytes route's tiles and a
    natively packed span wave: ``_bucket_out`` returns, tile by tile, the
    arrays of the old finish-time fetch of the same outputs."""
    tok = _tok(n)
    rng = np.random.default_rng(40 + n)
    if route == "tiles":
        batches = _tiles(tok, n, rng)
        wave = tok._dispatch_tiles(batches)
    else:
        lens = rng.integers(2, 80, 600).tolist() + [700, 1100, 1900]
        buf, starts, ends = _wave(rng, lens)
        buf = bytes(np.frombuffer(buf, np.uint8) % 26 + 97)
        handle = tok._dispatch_device_spans(buf, np.arange(len(lens), dtype=np.int32), starts, ends)
        batches, wave = handle[5].batches, handle[6]
        assert {t.l_max for t in batches} >= {1024, 2048}
    assert len(wave.done) == n and all(e is None for e in wave.done)
    want = _fetch_shards_as_before(wave.outs, len(batches), n)
    got = tok._bucket_out(batches, wave)
    assert wave.host is None
    assert len(got) == len(want) == len(batches)
    for (rows, counts), (ids, c) in zip(got, want):
        assert rows.dtype == ids.dtype == np.int32 and counts.dtype == c.dtype
        np.testing.assert_array_equal(rows.T, ids)
        np.testing.assert_array_equal(counts, c)
    assert tok.stats.device_pieces == sum(b.n_real for b in batches)
