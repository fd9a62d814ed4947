"""The port stands on its own: no import of the JAX package, own host layers.

``tokenizer_tpu_torch`` keeps copies of the JAX package's host modules
under the same names.  These tests hold the copies to their originals
(the pair tables they build, the vendored rank file, the vocabulary
resolution) and check that the port's native scanner builds into a cache
directory of its own, so that the two packages never load each other's
library even inside one process.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import require_vocab

REPO = Path(__file__).resolve().parent.parent

#: Files of the port that must not import the JAX package or bench.py.
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (
        *(REPO / "tokenizer_tpu_torch").rglob("*.py"),
        REPO / "chip_smoke.py",
        REPO / "tools" / "exp_cuda_probe.py",
        REPO / "tools" / "profile_torch_stream.py",
    )
)


def _imported_modules(path: Path):
    """Absolute module names imported anywhere in ``path`` (relative
    imports name the port's own modules and are skipped)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_the_jax_package(rel):
    bad = [
        m
        for m in _imported_modules(REPO / rel)
        if m.split(".")[0] in ("tokenizer_tpu", "bench", "jax", "jaxlib")
    ]
    assert not bad, f"{rel} imports {bad}"


def test_port_files_cover_the_host_layers():
    """Every module the port copied is walked by the static test."""
    for rel in (
        "tokenizer_tpu_torch/bpe.py",
        "tokenizer_tpu_torch/engine.py",
        "tokenizer_tpu_torch/gpu.py",
        "tokenizer_tpu_torch/vocab.py",
        "tokenizer_tpu_torch/models/registry.py",
        "tokenizer_tpu_torch/utils/lru.py",
        "tokenizer_tpu_torch/utils/text.py",
        "tokenizer_tpu_torch/ops/pair_table.py",
        "tokenizer_tpu_torch/ops/packing.py",
        "tokenizer_tpu_torch/runtime/native/__init__.py",
    ):
        assert rel in PORT_FILES


@pytest.mark.parametrize("name", ["gpt2", "cl100k_synth"])
def test_pair_table_equals_the_jax_package(name):
    require_vocab(name)
    from tokenizer_tpu.vocab import Vocabulary as JaxVocabulary
    from tokenizer_tpu_torch.vocab import Vocabulary

    ours = Vocabulary.for_encoding(name, allow_fetch=False).pair_table()
    ref = JaxVocabulary.for_encoding(name, allow_fetch=False).pair_table()
    for k in ("key_left", "key_right", "values", "byte_to_id"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k), err_msg=k)
    for k in ("slot_bits", "max_probes", "n_vocab", "max_token_len", "n_pairs",
              "unreachable_tokens"):
        assert getattr(ours, k) == getattr(ref, k), k


def test_vendored_gpt2_rank_file_is_the_jax_package_s():
    ours = REPO / "tokenizer_tpu_torch" / "assets" / "gpt2.tiktoken.gz"
    ref = REPO / "tokenizer_tpu" / "assets" / "gpt2.tiktoken.gz"
    assert ours.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("name", ["gpt2", "p50k_base", "cl100k_synth"])
def test_vocab_resolves_offline_like_the_jax_package(name):
    require_vocab(name)
    from tokenizer_tpu.vocab import load_encoding_ranks as jax_ranks
    from tokenizer_tpu_torch.vocab import load_encoding_ranks, resolve_vocab_file

    path = resolve_vocab_file(name, allow_fetch=False)
    if name == "gpt2":
        assert path == REPO / "tokenizer_tpu_torch" / "assets" / "gpt2.tiktoken.gz"
    assert load_encoding_ranks(name, allow_fetch=False) == jax_ranks(name, allow_fetch=False)


def test_parsed_vocab_cache_is_the_port_s_own(tmp_path, monkeypatch):
    monkeypatch.setenv("TOKENIZER_TPU_CACHE_DIR", str(tmp_path))
    from tokenizer_tpu_torch.vocab import load_tiktoken_file

    src = tmp_path / "tiny.tiktoken"
    src.write_bytes(b"YQ== 0\nYg== 1\nYWI= 2\n")
    assert load_tiktoken_file(src) == {b"a": 0, b"b": 1, b"ab": 2}
    assert list((tmp_path / "parsed_torch").glob("tiny.tiktoken.*.npz"))
    assert not (tmp_path / "parsed").exists()
    assert load_tiktoken_file(src) == {b"a": 0, b"b": 1, b"ab": 2}  # from the cache


def test_native_library_builds_in_its_own_cache_dir(tmp_path):
    """In one process, both packages' native scanners build and load, each
    from its own directory, and split alike."""
    code = (
        "from tokenizer_tpu_torch.runtime import native as ours\n"
        "from tokenizer_tpu.runtime import native as ref\n"
        "assert ours.available() and ref.available()\n"
        "assert ours._LIB is not ref._LIB and ours._LIB._name != ref._LIB._name\n"
        "text = 'Hello, world! 12345 étoile ⭐'.encode()\n"
        "assert list(ours.presplit(text, 1)) == list(ref.presplit(text, 1))\n"
        "print(ours._LIB._name)\n"
        "print(ref._LIB._name)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env |= {"PYTHONPATH": str(REPO), "TOKENIZER_TPU_CACHE_DIR": str(tmp_path)}
    env.pop("TOKENIZER_TPU_NO_NATIVE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True,
        timeout=600, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    ours, ref = out.stdout.strip().splitlines()[-2:]
    assert Path(ours).parent == tmp_path / "native_torch"
    assert Path(ref).parent == tmp_path / "native"
    assert list((tmp_path / "native_torch").glob("libttpresplit-*.so"))
