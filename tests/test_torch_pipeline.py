"""The port's corpus pipeline against the JAX package's, on the CPU.

Both ``encode_corpus`` implementations run on the same seeded documents:
the port's with ``GpuTokenizer(device="cpu")`` and every wave forced onto
the plain merge (so ``encode_batch_stream`` defers chunks as it does on a
card), the JAX package's with its ``TpuTokenizer`` on the CPU mesh.  The
npz ids and offsets, the manifest counters (all but ``seconds``) and the
digest sidecar must be equal, exactly.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import require_vocab

import tokenizer_tpu_torch as tt
from tokenizer_tpu import create_by_encoder_name as create_jax
from tokenizer_tpu.runtime import pipeline as jax_pipeline
from tokenizer_tpu_torch.runtime import pipeline


def _docs(n: int, seed: int):
    """Documents of prose with fresh words, numbers, CJK and an emoji."""
    rng = np.random.default_rng(seed)
    alpha = "abcdefghijklmnopqrstuvwxyz"
    docs = []
    for i in range(n):
        words = [
            "".join(alpha[j] for j in rng.integers(0, 26, size=int(rng.integers(1, 9))))
            for _ in range(int(rng.integers(5, 60)))
        ]
        cjk = "".join(map(chr, rng.integers(0x4E00, 0x4E00 + 500, size=int(rng.integers(0, 12)))))
        docs.append(f"doc {i}: {' '.join(words)} {int(rng.integers(1e9))} {cjk} ⭐")
    return docs


DOCS = _docs(48, seed=7)


@pytest.fixture(scope="module")
def toks():
    """(port tokenizer with every wave forced to the merge, JAX TpuTokenizer)."""
    require_vocab("gpt2")
    port = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu")
    port._host_pp = float("inf")
    port._host_wave_max = 0
    return port, create_jax("gpt2", allow_fetch=False, use_tpu=True)


def _outputs(out_dir: Path) -> dict:
    """Every file of an output directory, comparable: npz as (ids,
    offsets), manifests without ``seconds``, other files as bytes."""
    got = {}
    for f in sorted(out_dir.iterdir()):
        if f.suffix == ".npz":
            z = np.load(f)
            got[f.name] = (z["ids"].tolist(), z["offsets"].tolist())
        elif f.suffix == ".json":
            state = json.loads(f.read_text())
            state.pop("seconds")
            got[f.name] = state
        else:
            got[f.name] = f.read_bytes()
    return got


def _both(toks, tmp_path, docs=DOCS, **kw):
    """Run both pipelines into sibling directories; returns their outputs
    and progress records.  The port starts cold, so its waves merge."""
    port, jax_tok = toks
    port._reset_dedup_full()
    p = pipeline.encode_corpus(docs, port, tmp_path / "port", **kw)
    j = jax_pipeline.encode_corpus(docs, jax_tok, tmp_path / "jax", **kw)
    return _outputs(tmp_path / "port"), _outputs(tmp_path / "jax"), p, j


@pytest.mark.parametrize("n_shards", [1, 2])
def test_shards_match_the_jax_pipeline(toks, tmp_path, n_shards):
    before = toks[0].stats.device_pieces
    docs_seen = 0
    for shard in range(n_shards):
        got, want, p, j = _both(
            toks, tmp_path, chunk_bytes=900, shard=shard, n_shards=n_shards
        )
        assert got == want
        assert p.chunks_done == j.chunks_done > 2
        docs_seen += p.docs
    assert docs_seen == len(DOCS)
    assert toks[0].stats.device_pieces > before  # the merge route ran


def test_partial_resume_matches_the_jax_pipeline(toks, tmp_path):
    kw = dict(chunk_bytes=900, shard=0, n_shards=1)
    full, want, p, _ = _both(toks, tmp_path, **kw)
    for side in ("port", "jax"):
        m = tmp_path / side / "manifest_shard00000.json"
        state = json.loads(m.read_text())
        state["chunks_done"] -= 2
        m.write_text(json.dumps(state))
    got, want2, p2, j2 = _both(toks, tmp_path, **kw)
    assert p2.chunks_done == j2.chunks_done == p.chunks_done
    # The two re-run chunks were encoded again: counters count them twice,
    # alike, and the npz files are those of the full run.
    assert got == want2
    assert {k: v for k, v in got.items() if k.endswith(".npz")} == {
        k: v for k, v in full.items() if k.endswith(".npz")
    }


def test_interrupted_stream_resumes_to_the_same_files(toks, tmp_path):
    """A run stopped by its document source mid-corpus (chunks in flight
    are dropped), then resumed, leaves the npz of one uninterrupted run."""
    port, _ = toks
    kw = dict(chunk_bytes=900, shard=0, n_shards=1)
    whole = pipeline.encode_corpus(DOCS, port, tmp_path / "whole", **kw)

    class Stop(Exception):
        pass

    def stopping():
        for k, d in enumerate(DOCS):
            if k == len(DOCS) // 2:
                raise Stop
            yield d

    with pytest.raises(Stop):
        pipeline.encode_corpus(stopping(), port, tmp_path / "cut", **kw)
    cut = json.loads((tmp_path / "cut" / "manifest_shard00000.json").read_text())
    assert 0 < cut["chunks_done"] < whole.chunks_done
    resumed = pipeline.encode_corpus(DOCS, port, tmp_path / "cut", **kw)
    assert resumed.chunks_done == whole.chunks_done
    a, b = _outputs(tmp_path / "whole"), _outputs(tmp_path / "cut")
    assert {k: v for k, v in a.items() if k.endswith(".npz")} == {
        k: v for k, v in b.items() if k.endswith(".npz")
    }
    assert a["manifest_shard00000.digests"] == b["manifest_shard00000.digests"]


def test_mutated_corpus_is_refused_like_the_jax_pipeline(toks, tmp_path):
    port, jax_tok = toks
    docs = list(DOCS)
    for side, mod, tok in (("port", pipeline, port), ("jax", jax_pipeline, jax_tok)):
        mod.encode_corpus(docs, tok, tmp_path / side, chunk_bytes=600)
    docs[1] = docs[1] + " MUTATED"
    for side, mod, tok in (("port", pipeline, port), ("jax", jax_pipeline, jax_tok)):
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            mod.encode_corpus(docs, tok, tmp_path / side, chunk_bytes=600)


def test_shard_mismatch_is_refused_like_the_jax_pipeline(toks, tmp_path):
    port, jax_tok = toks
    for side, mod, tok in (("port", pipeline, port), ("jax", jax_pipeline, jax_tok)):
        mod.encode_corpus(DOCS, tok, tmp_path / side, chunk_bytes=900, shard=0, n_shards=2)
        with pytest.raises(ValueError, match="was written for shard"):
            mod.encode_corpus(DOCS, tok, tmp_path / side, chunk_bytes=900, shard=0, n_shards=4)


def test_host_engine_branch_matches_the_jax_pipeline(tmp_path):
    """``device=None`` gives the host engine, which has no bulk API, so the
    pipeline encodes document by document (``corpus --no-gpu``)."""
    require_vocab("gpt2")
    host = tt.create_by_encoder_name("gpt2", allow_fetch=False, device=None)
    assert type(host) is tt.TikTokenizer and not hasattr(host, "encode_batch")
    jax_host = create_jax("gpt2", allow_fetch=False)
    pipeline.encode_corpus(DOCS, host, tmp_path / "port", chunk_bytes=700)
    jax_pipeline.encode_corpus(DOCS, jax_host, tmp_path / "jax", chunk_bytes=700)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")


def test_default_shard_comes_from_the_job(toks, tmp_path, monkeypatch):
    """Without shard arguments the shard is this process's rank: 0 of 1
    alone, torchrun's RANK of WORLD_SIZE under a launcher; a world size
    without a rank raises instead of encoding everything as shard 0."""
    port, jax_tok = toks
    alone = pipeline.encode_corpus(DOCS, port, tmp_path / "alone", chunk_bytes=900)
    assert (alone.shard, alone.n_shards) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    p = pipeline.encode_corpus(DOCS, port, tmp_path / "port", chunk_bytes=900)
    assert (p.shard, p.n_shards) == (1, 2)
    jax_pipeline.encode_corpus(
        DOCS, jax_tok, tmp_path / "jax", chunk_bytes=900, shard=1, n_shards=2
    )
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="RANK"):
        pipeline.encode_corpus(DOCS, port, tmp_path / "norank", chunk_bytes=900)


def test_iter_corpus_files_matches_and_fails_loud(tmp_path):
    (tmp_path / "a.txt").write_text("alpha")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "b.txt").write_text("beta ⭐\r\nline")
    assert list(pipeline.iter_corpus_files([str(tmp_path)])) == list(
        jax_pipeline.iter_corpus_files([str(tmp_path)])
    )
    gone = tmp_path / "b.txt"
    gone.write_text("vanishing")
    (tmp_path / "c.txt").write_text("gamma")

    def vanish_mid_walk(**kw):
        it = pipeline.iter_corpus_files([str(tmp_path)], **kw)
        yield next(it)
        gone.unlink()
        yield from it

    with pytest.raises(OSError, match="unreadable corpus file"):
        list(vanish_mid_walk())
    gone.write_text("vanishing")
    skipped = []
    docs = list(vanish_mid_walk(on_skip=lambda p, e: skipped.append(str(p))))
    assert docs == ["alpha", "gamma", "beta ⭐\nline"]
    assert skipped == [str(gone)]


REPO = Path(__file__).resolve().parent.parent


def _tree_nested(root):
    for rel, text in (("z.txt", "zed"), ("a/y.txt", "why"), ("a/b/c/x.txt", "deep"),
                      ("a/b/w.txt", "double-u"), ("m/n/o.txt", "oh")):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return [str(root)], None


def _tree_parts_order(root):
    # as parts a < a b < a-b < a.b < a0; as strings "a-b/x" < "a.b/x" < "a/x"
    for rel in ("a/x", "a-b/x", "a.b/x", "a0", "a/x0/y", "a b/x"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(rel)
    return [str(root)], ["a/x", "a/x0/y", "a b/x", "a-b/x", "a.b/x", "a0"]


def _tree_dots(root):
    (root / ".dir").mkdir()
    (root / ".dir" / "in.txt").write_text("in a dot-directory")
    (root / ".hidden").write_text("a dotfile")
    (root / "plain.txt").write_text("plain")
    return [str(root)], ["in a dot-directory", "a dotfile", "plain"]


def _tree_symlinks(root):
    (root / "real").mkdir()
    (root / "real" / "f.txt").write_text("target")
    (root / "outside").mkdir()
    (root / "outside" / "g.txt").write_text("behind a linked directory")
    corpus = root / "corpus"
    corpus.mkdir()
    (corpus / "own.txt").write_text("own")
    (corpus / "file_link").symlink_to(root / "real" / "f.txt")
    (corpus / "dir_link").symlink_to(root / "outside", target_is_directory=True)
    (corpus / "dangling").symlink_to(root / "missing.txt")
    return [str(corpus)], ["target", "own"]


def _tree_bytes(root):
    big = b"x" * 65535 + "é".encode() + b"\r\n" * 300_000 + b"\xe2\x82" + "⭐".encode() * 200_000
    for name, data in (
        ("empty", b""),
        ("crlf", b"one\r\ntwo\r\n"),
        ("lone_cr", b"one\rtwo\r\r\nthree\r"),
        ("invalid", b"ok \xff\xfe bad \xed\xa0\x80 surrogate \xc3"),
        ("truncated", b"euro \xe2\x82"),
        ("bom", b"\xef\xbb\xbfbom then text\r\n"),
        ("bom_twice", b"\xef\xbb\xbf\xef\xbb\xbftwo"),
        ("big", big + b"\r"),
    ):
        (root / name).write_bytes(data)
    assert (root / "big").stat().st_size > 1 << 20  # several reads a file
    return [str(root)], None


def _tree_file_given(root):
    (root / "doc.txt").write_bytes(b"given \r\n directly")
    return [str(root / "doc.txt")], ["given \n directly"]


def _tree_several(root):
    for sub in ("one", "two"):
        (root / sub / "d").mkdir(parents=True)
        (root / sub / "d" / "x.txt").write_text(f"{sub} x")
        (root / sub / "y.txt").write_text(f"{sub} y")
    (root / "lone.txt").write_text("lone")
    paths = [str(root / "two"), str(root / "lone.txt"), str(root / "one") + "/"]
    return paths, ["two x", "two y", "lone", "one x", "one y"]


def _tree_corpus(root):
    """A 0.25 MB corpus, generated and written as bench_torch.corpus_cell
    writes the benchmark's (the bench computes its reference ids from
    documents read by this function, so only this case guards the read)."""
    sys.path.insert(0, str(REPO))
    from bench_torch import seed_text
    from chip_smoke import gen_corpus

    docs = gen_corpus(0.25, 0, seed_text())
    (root / "corpus").mkdir()
    for i, doc in enumerate(docs):
        (root / "corpus" / f"doc{i:06d}.txt").write_text(doc, encoding="utf-8")
    return [str(root / "corpus")], docs


@pytest.mark.parametrize("tree", [
    _tree_nested, _tree_parts_order, _tree_dots, _tree_symlinks, _tree_bytes,
    _tree_file_given, _tree_several, _tree_corpus,
], ids=lambda f: f.__name__[len("_tree_"):])
def test_iter_corpus_files_reads_as_the_jax_pipeline(tmp_path, tree):
    """The port's stat-free walk and raw read give the JAX function's
    documents in its order: parts order, dot names, symlinks, newlines,
    invalid UTF-8, a BOM, a file over several reads, several paths."""
    paths, want = tree(tmp_path)
    got = list(pipeline.iter_corpus_files(paths))
    assert got == list(jax_pipeline.iter_corpus_files(paths))
    if want is not None:
        assert got == want


def test_corpus_read_tool_records_every_variant(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    import corpus_read

    out = tmp_path / "corpus_read.json"
    assert corpus_read.main(["--mb", "0.1", "--rounds", "2", "--dir", str(tmp_path / "w"),
                             "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    names = ["walk_rglob", "walk_scandir", "read_text", "read_raw", "read_raw_t2",
             "read_raw_t4", "read_raw_t8", "one_file"]
    assert list(rec["variants"]) == names
    for v in rec["variants"].values():
        assert len(v["seconds"]) == 2 and v["median_s"] > 0 and v["us_per_file"] > 0
    assert rec["files"] == len(list((tmp_path / "w" / "corpus").iterdir())) > 10
    assert rec["bytes"] == (tmp_path / "w" / "one.txt").stat().st_size >= 100_000
    assert rec["fs_type"] and rec["cores"] >= 1 and rec["rounds"] == 2
    assert set(rec["walk_plus_read_s"]) == {"jax", "port"} and rec["port_over_jax"] > 0
