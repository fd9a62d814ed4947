"""The port's runtime pieces on the CPU: profiler, throughput meter, the
one upload per device wave, and ``device="cuda"`` refusing without a card.

The upload tests force every wave of ``GpuTokenizer(device="cpu")`` onto
the plain merge and check that each wave's tiles are views of one host
buffer, that the buffer is released once the wave's outputs are back
(and when a stream closes with a chunk in flight), and that the ids,
deferred stream chunks included, equal the JAX ``TpuTokenizer``'s.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import require_vocab

import tokenizer_tpu_torch as tt
from tokenizer_tpu import create_by_encoder_name as create_jax
from tokenizer_tpu_torch import cli
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.runtime import perf
from tokenizer_tpu_torch.runtime.profiler import ThroughputMeter, trace

REPO = Path(__file__).resolve().parent.parent


def test_throughput_meter(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("synchronized without a CUDA tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    m = ThroughputMeter()
    assert m.mb_per_s == 0.0 and m.tokens_per_s == 0.0
    with m:
        m.add(nbytes=3_000_000, ntokens=750)
    with m:
        m.add(nbytes=1_000_000, ntokens=250)
    assert (m.bytes, m.tokens) == (4_000_000, 1000) and m.seconds > 0
    assert m.mb_per_s == pytest.approx(4.0 / m.seconds)
    assert m.tokens_per_s == pytest.approx(1000 / m.seconds)
    tree = {"a": [torch.ones(3), (np.zeros(2), torch.zeros(1))], "b": None}
    assert m.block_until_ready(tree) is tree


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.arange(1000).sum()
    (f,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(f.read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)


@pytest.fixture
def forced():
    require_vocab("cl100k_synth")
    tok = tt.create_by_encoder_name("cl100k_synth", allow_fetch=False, device="cpu")
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    return tok


def _watch_waves(tok, monkeypatch):
    """Record each wave's upload buffer, each merge's input storages, and
    whether the buffer was still held when the outputs were copied back."""
    waves, merges, held = [], [], []
    dispatch, bucket_out = tok._dispatch_tiles, tok._bucket_out

    def watch_dispatch(batches, *packed):
        wave = dispatch(batches, *packed)
        waves.append(wave)
        return wave

    def watch_bucket_out(batches, wave):
        held.append(wave.host is not None)
        return bucket_out(batches, wave)

    real = merge_cuda.merge_packed_torch

    def watch_merge(tab, ids, lengths, **kw):
        merges.append((ids.untyped_storage().data_ptr(), lengths.untyped_storage().data_ptr()))
        return real(tab, ids, lengths, **kw)

    monkeypatch.setattr(tok, "_dispatch_tiles", watch_dispatch)
    monkeypatch.setattr(tok, "_bucket_out", watch_bucket_out)
    monkeypatch.setattr(merge_cuda, "merge_packed_torch", watch_merge)
    return waves, merges, held


def test_one_upload_buffer_per_wave_and_ids_unchanged(forced, monkeypatch):
    sys.path.insert(0, str(REPO))
    from bench import gen_corpus

    docs = gen_corpus(0.06, seed=11) + ["", "CJK 你好世界 こんにちは", "9" * 40]
    jax_tok = create_jax("cl100k_synth", allow_fetch=False, use_tpu=True)
    want = jax_tok.encode_batch(docs)
    waves, merges, held = _watch_waves(forced, monkeypatch)

    chunks = [docs[i : i + 5] for i in range(0, len(docs), 5)]
    got = [ids for batch in forced.encode_batch_stream(chunks) for ids in batch]
    assert len(got) == len(docs)
    for d, g, w in zip(docs, got, want):
        assert np.array_equal(g, w), repr(d[:60])
    # Every device wave of the stream made exactly one upload buffer; each
    # of its tiles' ids and lengths are views of it.
    assert forced.stats.device_waves == len(waves) > 2
    assert all(w.outs for w in waves), "a device wave without tiles"
    assert len(merges) == sum(len(w.outs) for w in waves)
    assert len({ids for ids, _ in merges}) == len(waves)
    assert all(ids == lengths for ids, lengths in merges)
    # Held until the outputs came back, released right after.
    assert held == [True] * len(waves)
    assert all(w.host is None for w in waves)


def test_stream_closed_mid_flight_releases_the_upload(forced, monkeypatch):
    waves, _, _ = _watch_waves(forced, monkeypatch)
    chunks = [[f"chunk {k} fresh words {k * 7919} zq{k}x"] for k in range(4)]
    gen = forced.encode_batch_stream(chunks)
    next(gen)  # chunk 0 resolved; chunk 1's wave is in flight
    assert forced._stream_inflight == 1 and waves[-1].host is not None

    def fail(handle):
        raise RuntimeError("finish failed")

    monkeypatch.setattr(forced, "_finish_new_piece_rows", fail)
    gen.close()
    assert forced._stream_inflight == 0
    assert waves[-1].host is None


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_a_card_raises_through_every_entry(no_card, tmp_path):
    require_vocab("gpt2")
    with pytest.raises(RuntimeError, match="is_available"):
        tt.create_by_encoder_name("gpt2", allow_fetch=False)
    with pytest.raises(RuntimeError, match="is_available"):
        tt.create_by_model_name("gpt2", allow_fetch=False, device="cuda")
    for argv in (
        ["gpt2", "hello"],
        ["encode-file", "gpt2", str(REPO / "tests" / "testdata" / "lib.rs.txt")],
        ["bench", str(REPO / "tests" / "testdata"), "--min-seconds", "0"],
        ["corpus", str(REPO / "tests" / "testdata" / "lib.rs.txt"), "--out", str(tmp_path)],
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="is_available"):
        perf.run_folder_benchmark(str(REPO / "tests" / "testdata"), min_seconds=0)
    assert not list(tmp_path.iterdir())


def test_host_engine_rejects_device_options():
    require_vocab("gpt2")
    host = tt.create_by_encoder_name("gpt2", allow_fetch=False, device=None)
    assert type(host) is tt.TikTokenizer
    with pytest.raises(TypeError, match="max_unique_rows"):
        tt.create_by_encoder_name("gpt2", allow_fetch=False, device=None, max_unique_rows=8)
    gpu = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu", max_unique_rows=64)
    assert isinstance(gpu, tt.GpuTokenizer) and gpu._max_unique_rows == 64


def test_public_surface_is_the_jax_package_s():
    import tokenizer_tpu

    # Plus the mesh that GpuTokenizer(mesh=) takes, where TpuTokenizer
    # takes a jax.sharding.Mesh from jax itself.
    want = set(tokenizer_tpu.__all__) - {"TpuTokenizer"} | {"GpuTokenizer", "DataMesh", "data_mesh"}
    assert set(tt.__all__) == want
    for name in tt.__all__:
        assert getattr(tt, name) is not None
    assert tt.__version__ == tokenizer_tpu.__version__


@pytest.mark.parametrize("budget", [None, 7])
def test_folder_benchmark_matches_the_jax_harness(tmp_path, budget):
    """The JSON contract, the trim-suffix mode and ``profile_dir`` (one
    cycle traced) of the port's harness against the JAX one's."""
    require_vocab("gpt2")
    from tokenizer_tpu.runtime.perf import run_folder_benchmark as jax_benchmark

    folder = tmp_path / "corpus"
    (folder / "sub").mkdir(parents=True)
    (folder / "a.py").write_text("def f(x):\n    return x * 2  # étoile ⭐\n" * 20)
    (folder / "sub" / "b.md").write_text("# Title\n\nSome prose, 12345 words.\n" * 30)
    (folder / "skip.bin").write_bytes(b"\x00\x01")
    kw = dict(min_seconds=0, min_cycles=2, trim_suffix_budget=budget)
    got = perf.run_folder_benchmark(
        str(folder), device="cpu", profile_dir=str(tmp_path / "prof"), **kw
    )
    want = jax_benchmark(str(folder), **kw)
    assert got.keys() == want.keys()
    for k in ("totalSize", "tokens", "files"):
        assert got[k] == want[k], k
    assert got["files"] == 2 and got["n_cycles"] >= 2
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
    host = perf.run_folder_benchmark(str(folder), device=None, **kw)
    assert host["tokens"] == want["tokens"]
