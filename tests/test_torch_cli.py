"""The port's CLI against the JAX package's, on the CPU.

``main([...])`` of both CLIs with stdout captured: the port's with
``--device cpu`` (the plain PyTorch merge), the JAX package's as it runs
by default.  Token lines, counts, the bench report's keys and counts and
the corpus report and files must agree exactly; only times may differ.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from conftest import require_vocab

from tokenizer_tpu import cli as jax_cli
from tokenizer_tpu_torch import cli

REPO = Path(__file__).resolve().parent.parent
TESTDATA = REPO / "tests" / "testdata"
#: report fields that are times.
TIMED = {"shard_seconds", "shard_MBps", "cycles", "n_cycles", "mb_per_s_best", "mb_per_s_mean"}


@pytest.fixture(autouse=True)
def _gpt2():
    require_vocab("gpt2")


def _run(main, argv, capsys) -> list:
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize(
    "argv",
    [
        ["tokenize", "gpt2", "Hello World! 12345 étoile ⭐ <|endoftext|>"],
        ["gpt2", "bare form, like Tokenizer.exe"],
        ["tokenize", "cl100k_synth", "def f(x):\n    return x ** 2  # 你好"],
    ],
)
def test_tokenize_prints_what_the_jax_cli_prints(argv, capsys):
    require_vocab(argv[-2])
    got = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    assert got == _run(jax_cli.main, argv, capsys)
    assert len(got) >= 3


def test_encode_file_counts_the_golden(capsys):
    path = str(TESTDATA / "lib.rs.txt")
    got = _run(cli.main, ["encode-file", "gpt2", path, "--device", "cpu"], capsys)
    want = _run(jax_cli.main, ["encode-file", "gpt2", path], capsys)
    assert got[:2] == want[:2] == ["tokens: 11378", "bytes: 24292"]
    assert [line.split(":")[0] for line in got] == ["tokens", "bytes", "seconds", "MB/s"]


def test_bench_reports_like_the_jax_cli(capsys):
    argv = ["bench", str(TESTDATA), "--model", "gpt2", "--min-seconds", "0", "--min-cycles", "1"]
    (line,) = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    (want_line,) = _run(jax_cli.main, argv, capsys)
    got, want = json.loads(line), json.loads(want_line)
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k not in TIMED} == {
        k: v for k, v in want.items() if k not in TIMED
    }
    # lib.rs.txt and the eight tokens_*.json goldens
    assert got["files"] == 9 and got["tokens"] > 11378 and got["n_cycles"] >= 1


def _npz(out: Path) -> dict:
    return {
        f.name: (np.load(f)["ids"].tolist(), np.load(f)["offsets"].tolist())
        for f in sorted(out.glob("*.npz"))
    }


@pytest.mark.parametrize(
    "port_flags,jax_flags",
    [(["--device", "cpu"], []), (["--no-gpu"], ["--no-tpu"])],
    ids=["device", "host-engine"],
)
def test_corpus_reports_and_writes_like_the_jax_cli(tmp_path, capsys, port_flags, jax_flags):
    args = [str(TESTDATA / "lib.rs.txt"), str(TESTDATA / "tokens_gpt2.json"),
            "--model", "gpt2", "--chunk-bytes", "20000"]
    (line,) = _run(cli.main, ["corpus", *args, "--out", str(tmp_path / "port"), *port_flags], capsys)
    (want_line,) = _run(jax_cli.main, ["corpus", *args, "--out", str(tmp_path / "jax"), *jax_flags], capsys)
    got, want = json.loads(line), json.loads(want_line)
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k not in TIMED} == {
        k: v for k, v in want.items() if k not in TIMED
    }
    assert got["chunks_done"] == 2 and got["global_docs"] == 2
    assert _npz(tmp_path / "port") == _npz(tmp_path / "jax")
    assert len(_npz(tmp_path / "port")) == 2
