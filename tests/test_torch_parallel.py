"""The port's mesh path on the CPU vs the JAX package's 8-device CPU mesh.

``tokenizer_tpu_torch.parallel`` shards a tile's columns over a
``DataMesh``; on the CPU its shards are ``cpu`` devices
(``data_mesh(devices=["cpu"] * 8)``) and each runs the plain PyTorch
merge.  The JAX side runs on the virtual 8-device CPU mesh of
``conftest.py``.  Token ids, counts and counters are int32 or int64, so
the tolerance is zero: every comparison is exact.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import find_testdata, require_vocab

jax = pytest.importorskip("jax")

import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch import gpu as gpu_mod
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.parallel import (
    DataMesh,
    data_mesh,
    gather_shards,
    local_batch_size,
    local_devices,
    make_sharded_merge_fn,
    sharded_merge_step,
)
from tokenizer_tpu_torch.parallel.mesh import local_device_indices

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8


@pytest.fixture
def plain_calls(monkeypatch):
    """The column shape of every plain merge behind the wrapper's CPU route."""
    calls = []
    real = merge_cuda.merge_packed_torch

    def counting(*a, **k):
        calls.append(tuple(a[1].shape))
        return real(*a, **k)

    monkeypatch.setattr(merge_cuda, "merge_packed_torch", counting)
    return calls


@pytest.fixture
def cards(monkeypatch):
    """Pretend ``n`` cards are visible, outside any job: only device
    objects are made, nothing is allocated on them."""

    def set_cards(n: int):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return set_cards


def _seeded_tile(table, L=16, B=1024, seed=3):
    """B columns of 2..L bytes of a-f, packed; the last 37 stay empty."""
    rng = np.random.default_rng(seed)
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    for c in range(B - 37):
        p = rng.integers(ord("a"), ord("g"), size=int(rng.integers(2, L + 1))).astype(np.uint8)
        ids[: len(p), c] = table.byte_to_id[p]
        lengths[c] = len(p)
    return ids, lengths


# -- the mesh ----------------------------------------------------------------


def test_data_mesh_of_cpu_shards():
    mesh = data_mesh(devices=CPU8)
    assert isinstance(mesh, DataMesh)
    assert mesh.size == 8 and mesh.shape == {"data": 8}
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert data_mesh(4, devices=CPU8).size == 4


def test_size_guard_raises_loudly(cards):
    cards(0)
    assert local_devices() == []
    with pytest.raises(ValueError, match="only 8 device"):
        data_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="no CUDA card"):
        data_mesh()
    cards(2)
    assert data_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"data_mesh\(4\) but only 2 device"):
        data_mesh(4)
    with pytest.raises(ValueError, match="only 2 card"):
        DataMesh(("cuda:0", "cuda:2"))
    with pytest.raises(ValueError, match="one kind"):
        DataMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="index"):
        DataMesh(("cuda",))


def test_mesh_divisibility_check():
    mesh = data_mesh(devices=CPU8)
    assert local_batch_size(1024, mesh) == 128
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(1001, mesh)


@pytest.mark.parametrize(
    "count,rank,world,want",
    [
        (4, 0, 1, [0, 1, 2, 3]),
        (4, 0, 2, [0, 1]),
        (4, 1, 2, [2, 3]),
        (4, 3, 4, [3]),
        (8, 2, 3, [6, 7]),
        (8, 0, 3, [0, 1, 2]),
        (1, 1, 2, [0]),  # more ranks than cards: shared round-robin
        (2, 3, 4, [1]),
        (0, 0, 1, []),
    ],
)
def test_local_device_indices(count, rank, world, want):
    assert local_device_indices(count, rank, world) == want


def test_local_devices_and_resolve_device_in_a_job(cards, monkeypatch):
    """Under torchrun, ``device="cuda"`` is the rank's own card, not card
    0 for every rank; with more ranks than cards they share."""
    cards(4)
    assert [d.index for d in local_devices()] == [0, 1, 2, 3]
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    for k in range(4):
        monkeypatch.setenv("LOCAL_RANK", str(k))
        assert local_devices() == [torch.device("cuda", k)]
        assert gpu_mod._resolve_device("cuda") == torch.device("cuda", k)
        assert gpu_mod._resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert [d.index for d in local_devices()] == [2, 3]
    cards(1)  # the one-card host of a two-rank job
    for k in range(2):
        monkeypatch.setenv("LOCAL_RANK", str(k))
        assert gpu_mod._resolve_device("cuda") == torch.device("cuda", 0)
    # No LOCAL_* variables: the job's rank and world size (one host).
    cards(4)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("RANK", "2")
    assert local_devices() == [torch.device("cuda", 2)]


def test_mesh_auto_and_none_resolution(cards, monkeypatch):
    require_vocab("gpt2")
    cards(2)
    vocab = tt.Vocabulary.for_encoding("gpt2", allow_fetch=False)
    spec = tt.models.registry.get_encoding_spec("gpt2")

    def make(**kw):
        return GpuTokenizer(vocab, spec.special_tokens, spec.pattern, **kw)

    tok = make()  # "cuda", mesh="auto", two cards
    assert tok.mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tok.device == torch.device("cuda", 0)
    assert make(mesh=None).mesh is None
    one = make(device="cuda:1")
    assert one.mesh is None and one.device == torch.device("cuda", 1)
    assert make(device="cpu").mesh is None
    given = data_mesh(devices=["cuda:1", "cuda:1"])
    assert make(mesh=given).mesh is given
    assert make(mesh=data_mesh(1)).mesh is None  # one device is no mesh
    with pytest.raises(ValueError, match="only 2 device"):
        make(mesh=data_mesh(4))
    with pytest.raises(ValueError, match="cpu devices"):
        make(mesh=data_mesh(devices=CPU8))
    with pytest.raises(TypeError, match="DataMesh"):
        make(mesh="all")
    with pytest.raises(TypeError, match="mesh"):
        tt.create_by_encoder_name("gpt2", allow_fetch=False, device=None, mesh=None)
    cards(1)  # one card: "auto" stays on it
    assert make().mesh is None
    # A job of two ranks on a four-card host: each rank meshes its two.
    cards(4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert make().mesh.devices == (torch.device("cuda", 2), torch.device("cuda", 3))


# -- the sharded merge step ----------------------------------------------------


@pytest.fixture(scope="module")
def toy_tables():
    """The toy vocabulary of tests/test_parallel.py, as both packages'
    pair tables."""
    from tokenizer_tpu.ops.pair_table import PairTable as JaxPairTable
    from tokenizer_tpu.vocab import Vocabulary as JaxVocabulary
    from tokenizer_tpu_torch.ops.pair_table import PairTable
    from tokenizer_tpu_torch.vocab import Vocabulary

    enc = {bytes([b]): b for b in range(256)}
    for i, tok in enumerate([b"ab", b"cd", b"ef", b"abcd", b"cdef", b"abc"]):
        enc[tok] = 256 + i
    ours = PairTable.build(Vocabulary(dict(enc), name="toy"), verify_closure=False)
    ref = JaxPairTable.build(JaxVocabulary(dict(enc), name="toy"), verify_closure=False)
    return ours, ref


def _jax_sharded(ref_table, ids, lengths):
    from tokenizer_tpu.ops.merge_jax import device_table as jax_device_table
    from tokenizer_tpu.parallel import data_mesh as jax_data_mesh
    from tokenizer_tpu.parallel import make_sharded_merge_fn as jax_make

    fn = jax_make(ref_table, jax_data_mesh(8))
    o, n, c = fn(jax_device_table(ref_table), ids, lengths)
    return np.asarray(o), np.asarray(n), np.asarray(c)


@pytest.mark.parametrize("table_name", ["toy", "gpt2"])
def test_sharded_merge_equals_jax_on_eight_shards(table_name, toy_tables, plain_calls):
    if table_name == "toy":
        table, ref_table = toy_tables
    else:
        require_vocab("gpt2")
        from tokenizer_tpu.vocab import Vocabulary as JaxVocabulary

        table = tt.Vocabulary.for_encoding("gpt2", allow_fetch=False).pair_table()
        ref_table = JaxVocabulary.for_encoding("gpt2", allow_fetch=False).pair_table()
    ids, lengths = _seeded_tile(table)
    mesh = data_mesh(devices=CPU8)
    out_ids, out_n, counters = make_sharded_merge_fn(table, mesh)(ids, lengths)
    # Eight shards of 128 columns, each merged on its own.
    assert plain_calls == [(16, 128)] * 8
    assert [tuple(o.shape) for o in out_ids] == [(16, 128)] * 8
    assert [o.device for o in out_ids] == list(mesh.devices)
    assert [tuple(c.shape) for c in out_n] == [(128,)] * 8
    got_ids, got_n = gather_shards(out_ids, out_n)
    want_ids, want_n, want_c = _jax_sharded(ref_table, ids, lengths)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert counters.tolist() == want_c.tolist() == [int(want_n.sum()), 1024 - 37]
    assert (got_n < lengths).any()  # the tile merges


def test_sharded_merge_step_counts_one_shard(toy_tables):
    from tokenizer_tpu_torch.ops.merge_torch import device_table

    table, _ = toy_tables
    ids, lengths = _seeded_tile(table, B=128)
    o, n, c = sharded_merge_step(
        device_table(table, "cpu"),
        torch.from_numpy(ids),
        torch.from_numpy(lengths),
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    )
    assert c.tolist() == [int(n.sum()), int((lengths > 0).sum())]
    assert o.shape == (16, 128)


def test_sharded_merge_rejects_unaligned_shards(toy_tables):
    table, _ = toy_tables
    fn = make_sharded_merge_fn(table, data_mesh(devices=CPU8))
    ids, lengths = _seeded_tile(table, B=512)
    with pytest.raises(ValueError, match="multiple of 128"):
        fn(ids, lengths)
    with pytest.raises(ValueError, match="not divisible"):
        fn(ids[:, :100], lengths[:100])


# -- GpuTokenizer over the mesh ------------------------------------------------


def _mesh_port(name, n=8):
    require_vocab(name)
    mesh = data_mesh(devices=["cpu"] * n)
    return tt.create_by_encoder_name(name, allow_fetch=False, device="cpu", mesh=mesh), mesh


def test_mesh_tokenizer_golden_and_jax_mesh(lib_rs_text, plain_calls):
    """gpt2 on lib.rs.txt over eight cpu shards: the 11,378 golden ids,
    and TpuTokenizer(mesh=data_mesh(8))'s, with every merge a shard."""
    from tokenizer_tpu.engine import TikTokenizer as JaxHost
    from tokenizer_tpu.parallel import data_mesh as jax_data_mesh
    from tokenizer_tpu.tpu import TpuTokenizer
    from tokenizer_tpu.vocab import Vocabulary as JaxVocabulary

    tok, mesh = _mesh_port("gpt2")
    golden = json.loads(find_testdata("tokens_gpt2.json").read_text())
    (ids,) = tok.encode_batch([lib_rs_text])
    assert list(ids) == golden and len(golden) == 11378
    assert tok.mesh is mesh and tok._b_quantum == 8 * 128
    st = tok.stats
    assert st.device_waves == 1 and st.device_uploads == 8 and st.device_pieces > 0
    assert plain_calls and all(B in (128, 256, 512, 1024) for _, B in plain_calls)
    assert len(plain_calls) % 8 == 0

    spec = tt.models.registry.get_encoding_spec("gpt2")
    vocab = JaxVocabulary.for_encoding("gpt2", allow_fetch=False)
    jax_tok = TpuTokenizer(vocab, spec.special_tokens, spec.pattern, mesh=jax_data_mesh(8))
    texts = [lib_rs_text[:4000], lib_rs_text[4000:9000], "⭐ étoile  123", ""]
    want = jax_tok.encode_batch(texts)
    assert jax_tok.stats.device_pieces > 0
    got = tok.encode_batch(texts)
    host = JaxHost(vocab, spec.special_tokens, spec.pattern)
    for t, g, w in zip(texts, got, want):
        assert list(g) == list(w) == host.encode(t)


def test_mesh_tokenizer_cl100k_synth_batch_and_stream(plain_calls):
    require_vocab("cl100k_synth")
    sys.path.insert(0, str(REPO))
    from bench import gen_corpus
    from tokenizer_tpu import create_by_encoder_name as create_jax
    from tokenizer_tpu.parallel import data_mesh as jax_data_mesh

    docs = gen_corpus(0.05, seed=9) + ["", "CJK 你好世界 こんにちは", "9" * 40]
    jax_tok = create_jax("cl100k_synth", allow_fetch=False, use_tpu=True, mesh=jax_data_mesh(8))
    want = jax_tok.encode_batch(docs)
    tok, mesh = _mesh_port("cl100k_synth")
    got = tok.encode_batch(docs)
    for d, g, w in zip(docs, got, want):
        assert np.array_equal(g, w), repr(d[:60])
    assert tok.mesh is mesh and tok.stats.device_pieces > 0
    tok._reset_dedup_full()
    chunks = [docs[i : i + 6] for i in range(0, len(docs), 6)]
    flat = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    assert len(flat) == len(docs)
    for d, g, w in zip(docs, flat, want):
        assert np.array_equal(g, w), repr(d[:60])
    st = tok.stats
    # Every wave went to the shards, however small: none to the host router.
    assert st.host_wave_pieces == 0 and st.fused_pieces == 0
    assert st.device_uploads == 8 * st.device_waves


def test_multi_tile_wave_uploads_once_per_shard(monkeypatch):
    """A wave of three tiles over four shards: one upload buffer laid out
    shard-major, one launch per tile and shard on columns of that shard,
    each reading a view of that buffer."""
    tok, mesh = _mesh_port("gpt2", n=4)
    calls, real = [], merge_cuda.merge_packed_torch

    def watch(tab, ids, lengths, **kw):
        calls.append((tuple(ids.shape), ids.untyped_storage().data_ptr(),
                      lengths.untyped_storage().data_ptr()))
        return real(tab, ids, lengths, **kw)

    monkeypatch.setattr(merge_cuda, "merge_packed_torch", watch)
    rng = np.random.default_rng(7)
    tiles = []
    for L, B in ((16, 512), (64, 1024), (16, 512)):
        ids = np.full((L, B), -1, np.int32)
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        for c, n in enumerate(lengths):
            ids[:n, c] = tok.table.byte_to_id[rng.integers(97, 123, n)]
        tiles.append(SimpleNamespace(ids=ids, lengths=lengths, n_real=B))
    wave = tok._dispatch_tiles(tiles)
    assert tok.stats.device_uploads == 4 and len(wave.streams) == 4
    assert [shape for shape, _, _ in calls] == [(16, 128), (64, 256), (16, 128)] * 4
    # Shard k's part: each tile's k-th column block of ids, then lengths.
    part = sum(L * B // 4 + B // 4 for L, B in (t.ids.shape for t in tiles))
    host = wave.host.numpy()
    assert host.size == 4 * part
    for k in range(4):
        seg, i = host[k * part : (k + 1) * part], 0
        for t in tiles:
            L, B = t.ids.shape
            np.testing.assert_array_equal(
                seg[i : i + L * B // 4].reshape(L, B // 4), t.ids[:, k * B // 4 : (k + 1) * B // 4]
            )
            i += L * B // 4
        for t in tiles:
            B = t.ids.shape[1]
            np.testing.assert_array_equal(seg[i : i + B // 4], t.lengths[k * B // 4 : (k + 1) * B // 4])
            i += B // 4
    storage = wave.host.untyped_storage().data_ptr()
    assert {p for _, ids_p, len_p in calls for p in (ids_p, len_p)} == {storage}
    out = tok._bucket_out(tiles, wave)
    assert wave.host is None
    from tokenizer_tpu.ops.merge_numpy import merge_packed_numpy

    for t, (rows, n) in zip(tiles, out):
        want_ids, want_n = merge_packed_numpy(t.ids, t.lengths, tok.table)
        np.testing.assert_array_equal(n, want_n)
        np.testing.assert_array_equal(rows.T, want_ids)


def test_dryrun_multidevice_on_eight_cpu_shards(capsys):
    from tokenizer_tpu_torch.parallel.dryrun import dryrun_multidevice

    rec = dryrun_multidevice(devices=CPU8)
    assert rec["devices"] == ["cpu"] * 8
    assert rec["step_pieces"] == 8 * 128 and rec["device_pieces"] > 0
    assert rec["device_uploads"] == 8 * rec["device_waves"]
    assert "dryrun_multidevice ok: 8 shards" in capsys.readouterr().out
    with pytest.raises(ValueError, match="only 8 device"):
        dryrun_multidevice(9, devices=CPU8)
