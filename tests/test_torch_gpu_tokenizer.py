"""GpuTokenizer on the CPU vs the JAX package, with the device route forced.

``device="cpu"`` runs the port's device plumbing (packing, one merge per
tile, one copy back per wave, the JAX package's row scatter) with the
plain PyTorch merge.  Every wave is forced onto that route the way the
JAX bench forces its device route (``_host_pp = inf``), and the port's
small-wave threshold is set to 0 so that test-sized waves reach the merge
too.  Token ids must match exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import find_testdata, require_vocab

import tokenizer_tpu_torch as tt
from tokenizer_tpu import create_by_encoder_name as create_jax
from tokenizer_tpu.engine import TikTokenizer
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.runtime import build

REPO = Path(__file__).resolve().parent.parent


def _forced(tok):
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    return tok


def _port(name):
    require_vocab(name)
    return _forced(tt.create_by_encoder_name(name, allow_fetch=False, device="cpu"))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts calls of the plain merge behind the wrapper's CPU route."""
    calls = []
    real = merge_cuda.merge_packed_torch

    def counting(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(merge_cuda, "merge_packed_torch", counting)
    return calls


@pytest.fixture(scope="module")
def gpt2_pair():
    require_vocab("gpt2")
    return _port("gpt2"), create_jax("gpt2", allow_fetch=False)


def _assert_match(tok, host, texts, allowed=None):
    got = tok.encode_batch(texts, allowed_special=allowed)
    assert len(got) == len(texts)
    for text, ids in zip(texts, got):
        assert list(ids) == host.encode(text, allowed_special=allowed), repr(text[:60])
    return got


@pytest.mark.parametrize(
    "encoding,golden,count",
    [("gpt2", "tokens_gpt2.json", 11378), ("p50k_base", "tokens_p50k_base.json", 7230)],
)
def test_lib_rs_golden(encoding, golden, count, lib_rs_text, plain_calls):
    tok = _port(encoding)
    expected = json.loads(find_testdata(golden).read_text())
    (ids,) = tok.encode_batch([lib_rs_text])
    assert len(ids) == count == len(expected)
    assert list(ids) == expected
    assert tok.decode(ids) == lib_rs_text
    assert plain_calls and tok.stats.device_pieces > 0
    assert tok.stats.device_waves == 1 and tok.stats.host_wave_pieces == 0


def test_cl100k_synth_matches_jax_tpu_tokenizer(plain_calls):
    """The north-star shape against the JAX TpuTokenizer on the test
    suite's 8-device CPU mesh, batch and stream."""
    require_vocab("cl100k_synth")
    sys.path.insert(0, str(REPO))
    from bench import gen_corpus

    docs = gen_corpus(0.08, seed=5) + ["", "CJK 你好世界 こんにちは", "9" * 40]
    jax_tok = create_jax("cl100k_synth", allow_fetch=False, use_tpu=True)
    jax_tok._ensure_device()  # resolve the mesh now so its waves shard
    assert jax_tok.mesh is not None
    want = jax_tok.encode_batch(docs)
    assert jax_tok.stats.device_pieces > 0

    tok = _port("cl100k_synth")
    got = tok.encode_batch(docs)
    for d, g, w in zip(docs, got, want):
        assert np.array_equal(g, w), repr(d[:60])
    assert plain_calls and tok.stats.device_pieces > 0

    tok._reset_dedup_full()
    chunks = [docs[i : i + 7] for i in range(0, len(docs), 7)]
    flat = [ids for batch in tok.encode_batch_stream(chunks) for ids in batch]
    assert len(flat) == len(docs)
    for d, g, w in zip(docs, flat, want):
        assert np.array_equal(g, w), repr(d[:60])


def test_specials_allowed_and_disallowed(gpt2_pair, plain_calls):
    tok, host = gpt2_pair
    texts = [
        "<|endoftext|>",
        "a<|endoftext|>b tokenizer",
        "<|endoftext|><|endoftext|> specials",
        "no specials here at all",
    ]
    _assert_match(tok, host, texts, allowed=["<|endoftext|>"])
    _assert_match(tok, host, [t + " again" for t in texts], allowed=None)
    assert plain_calls


def test_oversized_piece_takes_host_fallback(gpt2_pair):
    tok, host = gpt2_pair
    before = tok.stats.host_fallback_pieces
    texts = ["z" * 5000, "ok " + "9" * 300 + " tail", "q" * 700]
    got = _assert_match(tok, host, texts)
    assert tok.stats.host_fallback_pieces > before
    assert tok.decode(got[0]) == "z" * 5000


def test_empty_texts(gpt2_pair):
    tok, host = gpt2_pair
    _assert_match(tok, host, ["", "", "x", ""])
    assert tok.encode_batch([]) == []
    assert list(tok.encode_batch_stream(iter([]))) == []


def test_encode_batch_stream_matches_encode_batch(gpt2_pair, lib_rs_text, plain_calls):
    tok, host = gpt2_pair
    batches = [
        [lib_rs_text[:3000], "shared piece alpha beta"],
        ["shared piece alpha beta", lib_rs_text[3000:7000]],
        ["⭐ étoile 12345 streamed", lib_rs_text[:100]],
    ]
    got = list(tok.encode_batch_stream(iter(batches)))
    assert len(got) == len(batches)
    for g_batch, texts in zip(got, batches):
        for g, text in zip(g_batch, texts):
            assert list(g) == host.encode(text)
    assert plain_calls


def test_trims_and_decode(gpt2_pair):
    tok, host = gpt2_pair
    texts = [
        "The quick brown fox ⭐ jumps 1234 over the lazy dog!",
        "trim me from both ends, please: étoile 98765",
        "",
        "short",
    ]
    budgets = [1, 5, 3, 100]
    for text, b, res in zip(texts, budgets, tok.encode_trim_suffix_batch(texts, budgets)):
        assert (res.token_ids, res.text) == tuple(host.encode_trim_suffix(text, b))
    for text, res in zip(texts, tok.encode_trim_prefix_batch(texts, 4)):
        assert (res.token_ids, res.text) == tuple(host.encode_trim_prefix(text, 4))
    ids = tok.encode_batch(texts)
    assert tok.decode_batch(ids) == texts


def test_python_split_path_and_force_host_vocab(plain_calls):
    """A pattern the native scanner does not know takes the per-piece
    split and pack_pieces; an unreachable vocab token takes the oracle."""
    enc = {bytes([b]): b for b in range(256)}
    enc[b"xyz"] = 256
    enc[b"ab"] = 257
    specials = {"<|eot|>": 999}
    tok = _forced(GpuTokenizer(dict(enc), specials, r"[a-z]+|\s+|.", device="cpu"))
    host = TikTokenizer(dict(enc), specials, r"[a-z]+|\s+|.")
    assert tok._native_pid is None
    texts = ["xyz", "ab xyz ab", "xyzxyz", "abab cab"]
    for text, ids in zip(texts, tok.encode_batch(texts)):
        assert list(ids) == host.encode(text), repr(text)
    assert tok.stats.host_fallback_pieces >= 1 and plain_calls


def test_device_merge_of_one_tile(gpt2_pair):
    """The single-tile launch hook, copied back, equals the NumPy model."""
    from tokenizer_tpu.ops.merge_numpy import merge_packed_numpy

    tok, _host = gpt2_pair
    rng = np.random.default_rng(11)
    ids = np.full((16, 128), -1, np.int32)
    lengths = rng.integers(0, 17, 128).astype(np.int32)
    for c, n in enumerate(lengths):
        ids[:n, c] = tok.table.byte_to_id[rng.integers(97, 123, n)]
    out_ids, out_n = tok._device_merge_async(ids, lengths)
    want_ids, want_n = merge_packed_numpy(ids, lengths, tok.table)
    np.testing.assert_array_equal(out_ids.cpu().numpy(), want_ids)
    np.testing.assert_array_equal(out_n.cpu().numpy(), want_n)


def test_small_waves_stay_on_host_by_default(gpt2_pair):
    """Without forcing, waves of at most _HOST_WAVE_MAX pieces merge on
    the host, as in the JAX package."""
    require_vocab("gpt2")
    tok = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu")
    _tok, host = gpt2_pair
    _assert_match(tok, host, ["a handful of fresh pieces 12345"])
    assert tok.stats.device_pieces == 0 and tok.stats.host_wave_pieces > 0


def test_import_and_cpu_encode_leave_jax_out():
    """Importing the port, a CPU gpt2 encode through the merge route and
    the probe runner's CPU run load neither jax nor any module of the JAX
    package."""
    code = (
        "import importlib.util, sys\n"
        "import tokenizer_tpu_torch as tt\n"
        "from tokenizer_tpu_torch.ops import exp_probe, probe_cuda\n"
        "tok = tt.create_by_encoder_name('gpt2', allow_fetch=False, device='cpu')\n"
        "tok._host_pp = float('inf'); tok._host_wave_max = 0\n"
        "ids = tok.encode_batch(['hello world 12345', 'fresh pieces here'])\n"
        "assert tok.stats.device_pieces > 0\n"
        "spec = importlib.util.spec_from_file_location('runner', 'tools/exp_cuda_probe.py')\n"
        "runner = importlib.util.module_from_spec(spec); spec.loader.exec_module(runner)\n"
        "assert runner.main(['--table', 'gpt2', '--device', 'cpu', '--tile', '1']) == 0\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tokenizer_tpu' or m.startswith('tokenizer_tpu.')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=str(REPO),
        capture_output=True,
        text=True,
        timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        | {"PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        GpuTokenizer({bytes([b]): b for b in range(256)}, {}, r".", device="cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        GpuTokenizer({bytes([b]): b for b in range(256)}, {}, r".", device="meta")


def test_failed_nvcc_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("TOKENIZER_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_library()
    assert build.build_dir() == tmp_path / "cuda"
    assert not any((tmp_path / "cuda").glob("*.so"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
