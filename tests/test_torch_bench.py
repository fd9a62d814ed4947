"""bench_torch.py on the CPU: its cells at a tiny size, its checks and its names.

The cells of ``BENCHMARK.json`` run end to end on ``device="cpu"``, where
the wrapper takes the plain PyTorch merge, at a 0.1 MB corpus.  Their
records must carry every name ``BENCHMARK.json`` gives, with the device
metrics unmeasured (None) off the card.  A wrong id in the port's output,
or in the native fused merge that the port and its host-routed control
share, must fail the cell and name the document, since the ids are held
to Rust tiktoken; a cell that exists only as data (a forced o200k_synth
stream) must run with no code of its own; without a card ``main`` exits
non-zero and prints no metric; and K1's byte bound must follow from the
tile's inputs alone.  The entries and cells that BENCHMARK.json does not
hold (the bulk trims, decode, the rotation-active blend, the forced
o200k_synth stream, the four-card stream; ``tools/bench_entries.py``)
run as data at 0.05 MB, the four-card one over four ``cpu`` shards (a
``devices`` override) with its per-card fields one entry a shard; a
wrong id, trimmed text or decoded character fails them naming the
document; without the override the four-card case refuses to run where
fewer cards than its ``chips`` are visible; and the scan-threads and
overlap tools run at a tiny size.
"""

import contextlib
import dataclasses
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import find_testdata, require_vocab
from torch_cpu import one_torch_thread  # noqa: F401

import tokenizer_tpu_torch as tt
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.ops import merge_cuda
from tokenizer_tpu_torch.ops.merge_torch import device_table
from tokenizer_tpu_torch.ops.pair_table import MAX_RANK
from tokenizer_tpu_torch.runtime import native
from tokenizer_tpu_torch.runtime.native import SplitContext

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

sys.path.insert(0, str(REPO / "tools"))
import bench_entries  # noqa: E402

BENCH = bench_torch.load_benchmark()
CORPUS, STREAM = (w["name"] for w in BENCH["workloads"])
WORKLOADS = {w["name"]: w for w in BENCH["workloads"]}
CARD = {"card": "cpu (no card)", "kind": "cpu", "device_count": 0}
#: the device metrics, which only the card measures.
DEVICE_KEYS = (*bench_torch.DEVICE_KEYS, "k1_rows", "device_trace_complete", "peak_device_bytes")


def _sizes(mb: float, stream_reps: int = 2) -> dict:
    return {CORPUS: {"mb": mb, "repetitions": 1},
            STREAM: {"mb": mb, "repetitions": stream_reps, "k1_tile_width": 128}}


@pytest.fixture(scope="module")
def printed(tmp_path_factory):
    """Both cells at 0.1 MB on the CPU: (records, the JSON lines printed)."""
    require_vocab("cl100k_synth")
    pytest.importorskip("tiktoken")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        records = bench_torch.run([CORPUS, STREAM], 0, "cpu", CARD, overrides=_sizes(0.1),
                                  work=tmp_path_factory.mktemp("bench"))
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    return records, lines


@pytest.fixture(scope="module")
def benchmark():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [CORPUS, STREAM])
def test_cell_runs_end_to_end_on_cpu(printed, cell):
    records, lines = printed
    (rec,) = [r for r in lines if r["cell"] == cell]
    assert rec == json.loads(json.dumps(next(r for r in records if r["cell"] == cell)))
    reps = 1 if cell == CORPUS else 2
    for name, m in rec["metrics"].items():
        assert m["n"] == reps == len(m["samples"]), name
        assert m["q1"] <= m["median"] <= m["q3"] and m["median"] > 0, name
    assert rec["mismatched_documents"] == 0
    assert rec["documents_checked"] == rec["input"]["docs"] * (reps + 1 if cell == CORPUS else 2 * reps + 1)
    assert rec["chips"] == 1 and rec["config"] == "cl100k_synth" and rec["card"] == CARD["card"]
    assert rec["routing"] == "default"
    assert rec["control_MBps"]["n"] == len(rec["router"]) == len(rec["steal_share"]) == reps
    assert rec["control_MBps"]["median"] > 0
    assert all(s is None or 0 <= s <= 1 for s in rec["steal_share"])
    assert all(r["dedup_resets"] == 0 for r in rec["router"])  # 1 << 20 rows: no rotation
    # The scanner's counters over every pass of every repetition, and the traced one.
    passes = ["cold"] if cell == CORPUS else ["cold", "warm"]
    assert len(rec["scan_parts"]) == reps and all(list(r) == passes for r in rec["scan_parts"])
    for r in rec["scan_parts"]:
        assert all(list(r[p]) == list(native.SCAN_COUNTERS) for p in passes)
        assert r["cold"]["inserts"] > 0 and r["cold"]["calls"] > 0
        assert all(v >= 0 for p in passes for v in r[p].values())
        if cell == STREAM:  # a warm pass meets no piece first
            assert r["warm"]["calls"] > 0
            assert all(r["warm"][k] == 0 for k in ("inserts", "fused_short", "fused_long",
                                                      "gen_copies", "defer_off", "defer_capacity",
                                                      "defer_wide", "bpe_pieces", "patches"))
    parts = rec["layers"]["scan_parts"]
    assert list(parts["cold"]) == list(native.SCAN_COUNTERS) and parts["cold"]["inserts"] > 0
    assert list(parts["host_s"]) == BENCH["layer_metrics"]["scan_parts"]["methods"]
    assert parts["host_s"]["_build_segments"] > 0 and parts["host_s"]["_emit_outputs"] > 0
    inside = parts["in_emit_s"]
    assert "_native_encode_emit" not in inside and inside["_build_segments"] > 0
    assert sum(inside.values()) <= rec["layers"]["host_s"]["_native_encode_emit"]
    split = parts["split"]  # the native calls' wall and those parts, against the span
    assert split["seconds"] == {"native_call_s": parts["cold"]["call_s"], **inside}
    assert 0 < split["covered"] <= 1.01 and 0 < split["share_of_busy"]["intern_s"] < 1
    only_parts = set(parts["host_s"]) - set(bench_torch.host_methods(BENCH))
    assert not only_parts & set(rec["layers"]["host_s"])  # host_s keeps its own methods
    layers = rec["layers"]
    for k in DEVICE_KEYS:
        assert layers[k] is None, k  # not measured off the card
    assert layers["device_pieces"] > 0 and layers["device_waves"] > 0  # the merge route ran
    assert layers["unique_pieces"] >= layers["device_pieces"] + layers["host_wave_pieces"]
    host = layers["host_s"]
    assert set(bench_torch.host_methods(BENCH)) <= set(host) and host["_native_encode_emit"] > 0
    if cell == CORPUS:
        assert host["read"] > 0 and host["npz_write"] > 0
    else:
        assert set(layers["k1_tile_bound_us"]) == set(map(str, chip_smoke.BUCKETS))
        assert all(v > 0 for v in layers["k1_tile_bound_us"].values())
        assert all(v is None for v in layers["k1_tile_us"].values())


def test_benchmark_json_names_are_the_printed_ones(printed, benchmark):
    _, lines = printed
    by_cell = {r["cell"]: r for r in lines}
    workloads = benchmark["workloads"]
    assert [w["name"] for w in workloads] == [CORPUS, STREAM]
    assert set(by_cell) == {w["name"] for w in workloads}
    for w in workloads:
        assert w["chips"] == 1 and w["config"] in benchmark["configs"] and w["reduced"] and w["why"]
        assert w["command"].startswith("python3 bench_torch.py --seed 0 --cell " + w["name"])
        assert w["entry"] in bench_torch.ENTRIES and w["routing"] in ("default", "forced")
        assert by_cell[w["name"]]["chips"] == w["chips"]
    assert benchmark["command"] == "python3 bench_torch.py --seed 0"
    for cfg in benchmark["configs"].values():
        assert len(cfg["source"]) <= 200
    for name, m in benchmark["metrics"].items():
        assert m["unit"] == "MB/s" and m["direction"] == "higher"
        assert set(m["bound"]) == set(m["workloads"]) and all(0 < b < 1 for b in m["bound"].values())
        for cell in m["workloads"]:
            assert name in by_cell[cell]["metrics"], (name, cell)
    for name, m in benchmark["controls"].items():
        for cell in m["workloads"]:
            assert name in by_cell[cell], (name, cell)
    for name, m in benchmark["layer_metrics"].items():
        assert m["unit"]
        for cell in m["workloads"]:
            assert name in by_cell[cell]["layers"], (name, cell)
    for cell, rec in by_cell.items():  # and nothing printed that the file does not name
        assert set(rec["metrics"]) == {n for n, m in benchmark["metrics"].items()
                                       if cell in m["workloads"]}


@pytest.mark.parametrize("cell", [CORPUS, STREAM])
def test_a_wrong_id_fails_the_cell_and_names_the_document(monkeypatch, tmp_path, cell):
    require_vocab("cl100k_synth")
    pytest.importorskip("tiktoken")
    real = GpuTokenizer.encode_batch_stream

    def one_wrong_id(self, batches, *a, **k):
        for out in real(self, batches, *a, **k):
            out = list(out)
            out[3] = out[3].copy()
            out[3][0] += 1
            yield out

    monkeypatch.setattr(GpuTokenizer, "encode_batch_stream", one_wrong_id)
    with pytest.raises(bench_torch.BenchFailure, match=rf"{cell} repetition 0.*document 3 differs"):
        bench_torch.run([cell], 0, "cpu", CARD, overrides=_sizes(0.05, 1), work=tmp_path)


def wrong_table(table):
    """A copy of ``table`` whose pair ("t", "h") merges into the id of "ht"."""
    t, h = (int(table.byte_to_id[ord(c)]) for c in "th")
    (slot,) = np.nonzero((table.key_left == t) & (table.key_right == h))[0]
    values = table.values.copy()
    values[slot] = table.lookup(np.array([h], np.int32), np.array([t], np.int32))[0]
    return dataclasses.replace(table, values=values)


@pytest.mark.parametrize("where", ["port", "shared"])
@pytest.mark.parametrize("cell", [CORPUS, STREAM])
def test_a_wrong_id_in_a_fused_piece_fails_the_cell(monkeypatch, tmp_path, cell, where):
    """A fault in the native fused split+merge: only in the port's
    tokenizers, or in the code the port shares with its host-routed
    control.  tiktoken shares none of it, so either fails the cell.
    Chunks of a document or 4 KB keep each wave small enough to fuse."""
    require_vocab("cl100k_synth")
    pytest.importorskip("tiktoken")
    fused = []

    def corrupted(real):
        def call(self, data, seg_start, seg_end, table, *a, **k):
            if getattr(self, "corrupt", where == "shared") and k.get("fuse", True):
                fused.append(len(seg_start))
                table = wrong_table(table)
            return real(self, data, seg_start, seg_end, table, *a, **k)

        return call

    for name in ("split_emit_batch", "split_merge_batch"):
        monkeypatch.setattr(SplitContext, name, corrupted(getattr(SplitContext, name)))
    make_tok = bench_torch.make_tok

    def corrupt_port(*a, **k):
        tok = make_tok(*a, **k)
        tok._split_ctx = SplitContext(tok._native_pid)
        tok._split_ctx.corrupt = True
        return tok

    monkeypatch.setattr(bench_torch, "make_tok", corrupt_port)
    at = "host-routed control" if where == "shared" else "repetition 0"
    sizes = _sizes(0.05, 1)
    sizes[CORPUS]["chunk_bytes"], sizes[STREAM]["chunk_docs"] = 4096, 1
    with pytest.raises(bench_torch.BenchFailure, match=rf"{cell} {at}.*document \d+ differs from tiktoken"):
        bench_torch.run([cell], 0, "cpu", CARD, overrides=sizes, work=tmp_path)
    assert fused  # the fault was in the fused route


def test_a_new_cell_is_one_more_entry(tmp_path):
    """A forced o200k_synth stream, defined only in the benchmark's data,
    runs through the same code: every wave to the merge, none fused."""
    require_vocab("o200k_synth")
    pytest.importorskip("tiktoken")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"]["o200k_synth"] = {**bench["configs"]["cl100k_synth"], "encoding": "o200k_synth"}
    stream = next(w for w in bench["workloads"] if w["entry"] == "encode_batch_stream")
    bench["workloads"].append({**stream, "name": "o200k_synth-stream-forced", "config": "o200k_synth",
                               "routing": "forced", "mb": 0.05, "repetitions": 1,
                               "warm_pass": False, "warm_up_mb": 0.02, "k1_tile_width": None})
    with contextlib.redirect_stdout(io.StringIO()):
        (rec,) = bench_torch.run(["o200k_synth-stream-forced"], 0, "cpu", CARD, bench=bench,
                                 work=tmp_path)
    assert rec["config"] == "o200k_synth" and rec["routing"] == "forced"
    assert set(rec["metrics"]) == {"cold_MBps"} and rec["mismatched_documents"] == 0
    layers = rec["layers"]
    assert layers["device_pieces"] > 0 and layers["host_wave_pieces"] == layers["fused_pieces"] == 0
    assert "k1_tile_us" not in layers


@pytest.mark.parametrize("rows, h2d, d2h, complete", [
    (7, 6, 6, True), (5, 6, 6, False), (7, 5, 6, False), (7, 6, 5, False), (7, 12, 9, True)])
def test_an_incomplete_trace_is_not_the_cards_time(rows, h2d, d2h, complete):
    """Six device waves with seven K1 launches: the trace is complete only
    with a row for every launch and a copy each way for every wave."""
    assert bench_torch.trace_complete(rows, 7, {"h2d": h2d, "d2h": d2h}, 6) is complete
    for k in bench_torch.DEVICE_KEYS:
        assert "null when device_trace_complete is false" in BENCH["layer_metrics"][k]["layer"], k


def test_main_without_a_card_exits_nonzero_and_prints_no_metric(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(["--seed", "0"]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "is_available() is False" in captured.err
    # Alone in a directory, without the port beside it.
    shutil.copy(REPO / "bench_torch.py", tmp_path / "bench_torch.py")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _fake_cards(monkeypatch, count: int) -> None:
    """``count`` cards as the benchmark's entry points see them (name,
    count, nvidia-smi), main's build cache where it is, and the test
    process's own imports of jax and the JAX package hidden."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "fake card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(chip_smoke, "smi_line", lambda: "fake card, 1.00 W")
    monkeypatch.setenv("TOKENIZER_TPU_CACHE_DIR", str(native._cache_dir().parent))
    for m in [m for m in sys.modules if m in ("jax", "bench", "tokenizer_tpu") or m.startswith("tokenizer_tpu.")]:
        monkeypatch.delitem(sys.modules, m)  # this test process's own imports, not the benchmark's


def test_main_runs_each_cell_in_a_process_of_its_own(monkeypatch, capsys, tmp_path):
    """With a card (faked), ``main`` starts ``bench_torch.py --cell NAME``
    once per cell, prints each child's record and ends in the metric line;
    a child that fails fails the run."""
    _fake_cards(monkeypatch, 1)
    monkeypatch.setattr(bench_torch, "WORK", tmp_path)
    started, rc = [], {}

    def child(cmd, **k):
        assert cmd[1] == str(REPO / "bench_torch.py") and k["stdout"] == subprocess.DEVNULL
        name, out = cmd[cmd.index("--cell") + 1], Path(cmd[cmd.index("--out") + 1])
        started.append(name)
        out.write_text(json.dumps([{"cell": name, "metrics": {"cold_MBps": {"median": len(started)}}}]))
        return subprocess.CompletedProcess(cmd, rc.get(name, 0))

    monkeypatch.setattr(subprocess, "run", child)
    assert bench_torch.main(["--out", str(tmp_path / "all.json")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert started == [CORPUS, STREAM]
    assert [json.loads(x)["cell"] for x in lines[:2]] == started
    assert lines[-2] == "fake card, 1.00 W"
    last = json.loads(lines[-1])
    assert last["ok"] and last["cells"] == {CORPUS: {"cold_MBps": 1}, STREAM: {"cold_MBps": 2}}
    assert [r["cell"] for r in json.loads((tmp_path / "all.json").read_text())] == started
    started.clear()
    rc[STREAM] = 1
    assert bench_torch.main([]) == 1
    captured = capsys.readouterr()
    assert "ok" not in captured.out.splitlines()[-1] and f"{STREAM}: its process exited with 1" in captured.err


def test_bench_spread_gives_the_widest_gap_between_invocations(printed, tmp_path):
    """tools/bench_spread.py over three invocations' record files."""
    sys.path.insert(0, str(REPO / "tools"))
    import bench_spread

    _, lines = printed
    paths = []
    for k, scale in enumerate((1.0, 0.8, 1.25)):
        recs = json.loads(json.dumps(lines))
        for r in recs:
            for m in r["metrics"].values():
                m["median"] *= scale
            r["steal_share"] = [0.0, 0.02 * k, None]  # None: /proc/stat unread
        paths.append(tmp_path / f"bench_{k}.json")
        paths[-1].write_text(json.dumps(recs))
    got = bench_spread.spread(paths)
    for r in lines:
        for name, m in r["metrics"].items():
            want = [m["median"] * s for s in (1.0, 0.8, 1.25)]
            assert got[r["cell"]][name]["medians"] == want
            assert got[r["cell"]][name]["widest_gap"] == pytest.approx((1.25 - 0.8) / 1.25)
        ratios = [c / h for c, h in zip(r["metrics"]["cold_MBps"]["samples"], r["control_MBps"]["samples"])]
        ratio = got[r["cell"]]["cold_over_control"]  # the samples were not scaled
        assert ratio["medians"] == [pytest.approx(np.median(ratios))] * 3 and ratio["widest_gap"] == 0
        steal = got[r["cell"]]["steal_share"]
        assert steal["medians"] == pytest.approx([0.0, 0.01, 0.02]) and steal["widest_gap"] == 1
    recs = json.loads(json.dumps(lines))
    for r in recs:
        r["steal_share"] = [0.0]
    paths[0].write_text(json.dumps(recs))
    assert all(c["steal_share"]["widest_gap"] == 0 for c in bench_spread.spread(paths[:1]).values())


def test_k1_bound_follows_from_the_tile_inputs_alone(monkeypatch):
    """chip_smoke.plain_and_bound's bytes: the tile in and out, and the
    table bytes of every pair a tiktoken-order merge of each column meets,
    enumerated here by a Python loop; the kernel is never called."""
    require_vocab("gpt2")
    tok = tt.create_by_encoder_name("gpt2", allow_fetch=False, device="cpu")
    table = tok.table
    text = find_testdata("lib.rs.txt").read_text(encoding="utf-8")
    pieces = sorted({p.encode("utf-8") for p in tok._re.findall(text) if 2 <= len(p.encode()) <= 16})
    pieces = pieces[:128]
    ids, lengths = chip_smoke.pack(table, pieces, 16)
    pairs = set()
    for p in pieces:
        toks = [int(t) for t in table.byte_to_id[np.frombuffer(p, np.uint8)]]
        pairs.update(zip(toks, toks[1:]))
        while len(toks) > 1:
            ranks = table.lookup(np.array(toks[:-1], np.int32), np.array(toks[1:], np.int32))
            j = int(np.argmin(ranks))
            if ranks[j] == MAX_RANK:
                break
            toks[j : j + 2] = [int(ranks[j])]
            pairs.update(zip(toks, toks[1:]))
    left, right = (np.array(v, np.int32) for v in zip(*sorted(pairs)))
    want_table, n_pairs = chip_smoke.table_bytes(table, left, right)
    want = 2 * ids.nbytes + 2 * lengths.nbytes + want_table

    def no_kernel(*a, **k):
        raise AssertionError("the bound must not depend on the kernel")

    monkeypatch.setattr(merge_cuda, "merge_packed", no_kernel)
    (out_ids, out_n), b = chip_smoke.plain_and_bound(
        table, device_table(table, "cpu"), torch.from_numpy(ids), torch.from_numpy(lengths))
    assert b["pairs"] == n_pairs == len(pairs)
    assert b["tile_bytes"] + b["table_bytes"] == want
    assert b["bound_us"] == pytest.approx(want / chip_smoke.HBM_BYTES_PER_S * 1e6)
    assert (lengths - out_n.numpy()).sum() > 0  # the tile merges


# -- the cases of tools/bench_entries.py, and the tools --------------------------

TRIM_TS, TRIM_CS, TRIM_PREFIX, DECODE, BLEND, FORCED, MESH = bench_entries.CASES
#: the four-card case's shards on the CPU.
CPU_SHARDS = ["cpu"] * 4
#: each case at 0.05 MB and one repetition; the blend's two copies in
#: 4-document chunks through 1,024 dedup rows, so its generations rotate.
TINY = {"mb": 0.05, "warm_up_mb": 0.02}
SIZES = {BLEND: {**TINY, "blend_copies": 2, "max_unique_rows": 1 << 10, "chunk_docs": 4},
         FORCED: {**TINY, "k1_tile_width": 128}, MESH: {**TINY, "devices": CPU_SHARDS}}


def _run_case(case: str, tmp_path, **fields) -> dict:
    require_vocab(bench_entries.CASES[case].get("config", "cl100k_synth"))
    pytest.importorskip("tiktoken")
    overrides = {case: {**SIZES.get(case, TINY), **fields}}
    with contextlib.redirect_stdout(io.StringIO()):
        (rec,) = bench_torch.run([case], 0, "cpu", CARD, bench=bench_entries.with_cases(BENCH, 1),
                                 overrides=overrides, work=tmp_path)
    return rec


@pytest.mark.parametrize("case", list(bench_entries.CASES))
def test_a_case_of_bench_entries_runs_as_data(tmp_path, case):
    """Each case of tools/bench_entries.py through bench_torch.run on the
    CPU: cold and warm MB/s, every output checked, the router's and the
    steal meter's record per repetition; the blend rotates its dedup
    generations while timed and stays exact; the forced stream sends
    every wave to the merge, and so does the mesh, whose record names its
    shards and holds each per-card field one entry a shard (the device
    metrics and peak memory unmeasured off the card, no K1 launch on a
    CPU shard); decode says it ran no device work."""
    rec = _run_case(case, tmp_path)
    assert rec["entry"] == bench_entries.CASES[case]["entry"] and rec["mismatched_documents"] == 0
    assert set(rec["metrics"]) == {"cold_MBps", "warm_MBps"}
    assert all(m["n"] == 1 and m["median"] > 0 for m in rec["metrics"].values())
    assert rec["control_MBps"]["n"] == len(rec["router"]) == len(rec["steal_share"]) == 1
    (router,), layers, docs = rec["router"], rec["layers"], rec["input"]["docs"]
    assert set(bench_torch.DEDUP_COUNTERS) <= set(router)
    if case == DECODE:
        assert rec["documents_checked"] == 2 * docs
        assert layers == {"setup_s": layers["setup_s"], "host_only": True, "k1_launches": 0,
                          "device_waves": 0}
        assert router["device_waves"] == router["unique_pieces"] == 0
        return
    assert rec["documents_checked"] == 3 * docs  # cold, warm and traced
    assert set(bench_torch.host_methods(BENCH)) <= set(layers["host_s"])
    assert all(layers[k] is None for k in DEVICE_KEYS)
    if case == BLEND:
        assert rec["input"]["blend_copies"] == 2 and rec["input"]["max_unique_rows"] == 1 << 10
        assert router["dedup_resets"] > 0 and router["dedup_gen_copies"] > 0
    elif case == FORCED:
        assert rec["config"] == "o200k_synth" and rec["routing"] == "forced"
        assert router["device_pieces"] > 0 and router["host_wave_pieces"] == router["fused_pieces"] == 0
        assert set(layers["k1_tile_bound_us"]) == set(map(str, chip_smoke.BUCKETS))
    elif case == MESH:
        assert rec["chips"] == 4 and rec["shards"] == CPU_SHARDS and rec["cards"] is None
        assert rec["routing"] == "default" and "k1_tile_us" not in layers
        assert router["device_pieces"] > 0 and router["host_wave_pieces"] == router["fused_pieces"] == 0
        for k in (*bench_torch.CARD_KEYS, "peak_device_bytes_by_card"):
            assert layers[k] == [None] * 4, k
        assert layers["k1_launches_by_card"] == [0] * 4 and layers["k1_launches"] == 0
    else:
        assert layers["device_pieces"] > 0  # the trims' waves take the merge route
        assert rec["input"]["budget"] == bench_torch.TRIM_BUDGET
        assert rec["input"]["mode"] == {TRIM_TS: "ts", TRIM_CS: "cs", TRIM_PREFIX: None}[case]
        assert 0 < rec["input"]["tokens"] <= bench_torch.TRIM_BUDGET * docs


@pytest.mark.parametrize("visible", [1, 3])
def test_the_mesh_case_refuses_fewer_cards_than_its_chips(monkeypatch, capsys, tmp_path, visible):
    """Asked for by name where fewer distinct cards than its chips are
    visible, the four-card case fails before its set-up: rc != 0, no
    record and no metric line, no tokenizer on shards of one card."""
    _fake_cards(monkeypatch, visible)
    import ab_turns

    monkeypatch.setattr(ab_turns, "smi", lambda: "fake card, 1.00 W")

    def no_tokenizer(*a, **k):
        raise AssertionError("the case must refuse before it builds a tokenizer")

    monkeypatch.setattr(bench_torch, "make_tok", no_tokenizer)
    assert bench_entries.main(["--case", MESH, "--out", str(tmp_path / "mesh.json")]) == 1
    captured = capsys.readouterr()
    assert not [x for x in captured.out.splitlines() if x.startswith("{")]
    assert f"{MESH}: needs 4 distinct cards, this process sees {visible}" in captured.err


def test_the_mesh_case_without_its_devices_refuses_the_cpu(tmp_path):
    """With no card, bench_torch.run refuses the four-card case (no
    ``devices`` override) instead of sharding the CPU."""
    with pytest.raises(bench_torch.BenchFailure, match=f"{MESH}: needs 4 distinct cards, this process sees 0"):
        bench_torch.run([MESH], 0, "cpu", CARD, bench=bench_entries.with_cases(BENCH, 1),
                        overrides={MESH: TINY}, work=tmp_path)


@pytest.mark.parametrize("visible", [1, 4])
def test_bench_entries_leaves_out_cases_it_has_no_cards_for(monkeypatch, capsys, tmp_path, visible):
    """Without --case, tools/bench_entries.py starts one process per case
    it has the cards for, and names on stderr the ones it left out."""
    _fake_cards(monkeypatch, visible)
    started = []

    def child(cmd, **k):
        name, out = cmd[cmd.index("--case") + 1], Path(cmd[cmd.index("--out") + 1])
        started.append(name)
        out.write_text(json.dumps([{"cell": name, "metrics": {"cold_MBps": {"median": 1.0}}}]))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", child)
    assert bench_entries.main(["--device", "cpu", "--out", str(tmp_path / "all.json")]) == 0
    captured = capsys.readouterr()
    assert started == [c for c in bench_entries.CASES if visible == 4 or c != MESH]
    assert (f"leaving out ['{MESH}']" in captured.err) == (visible < 4)
    assert set(json.loads(captured.out.splitlines()[-1])["cells"]) == set(started)


def test_the_prefix_trim_refuses_a_mode(tmp_path):
    with pytest.raises(bench_torch.BenchFailure, match="encode_trim_prefix_batch takes no mode"):
        _run_case(TRIM_PREFIX, tmp_path, mode="ts")


def _wrong_id(out: list) -> None:
    ids = list(out[3].token_ids)
    ids[:1] = [ids[0] + 1] if ids else [0]  # a cs trim may keep no id
    out[3] = tt.TrimResult(ids, out[3].text)


def _wrong_text(out: list) -> None:
    out[3] = tt.TrimResult(out[3].token_ids, out[3].text[:-1])


def _wrong_char(out: list) -> None:
    out[3] = out[3][:5] + chr(ord(out[3][5]) + 1) + out[3][6:]


@pytest.mark.parametrize("case, method, corrupt, differs", [
    (TRIM_TS, "encode_trim_suffix_batch", _wrong_id, "tiktoken"),
    (TRIM_CS, "encode_trim_suffix_batch", _wrong_id, r"the host-routed control \(ids"),
    (TRIM_PREFIX, "encode_trim_prefix_batch", _wrong_id, r"the host-routed control \(ids"),
    (TRIM_TS, "encode_trim_suffix_batch", _wrong_text, r"the host-routed control \(text"),
    (TRIM_PREFIX, "encode_trim_prefix_batch", _wrong_text, r"the host-routed control \(text"),
    (DECODE, "decode_batch", _wrong_char, "its text"),
], ids=["ts-id", "cs-id", "prefix-id", "ts-text", "prefix-text", "decode-char"])
def test_a_wrong_output_fails_the_entry_and_names_the_document(monkeypatch, tmp_path, case, method,
                                                                corrupt, differs):
    """Document 3 of the port's output corrupted (the host-routed control
    left as it is): a suffix trim's id is held to tiktoken, every trim's
    ids and text to the control, a decoded text to its document."""
    make_tok = bench_torch.make_tok

    def corrupt_port(*a, **k):
        tok = make_tok(*a, **k)
        real = getattr(tok, method)

        def call(*a, **k):
            out = real(*a, **k)
            if len(out) > 3:
                corrupt(out)
            return out

        setattr(tok, method, call)
        return tok

    monkeypatch.setattr(bench_torch, "make_tok", corrupt_port)
    with pytest.raises(bench_torch.BenchFailure,
                       match=rf"{case} repetition 0, cold pass: document 3 differs from {differs}"):
        _run_case(case, tmp_path, warm_pass=False)


def test_steal_meter_sums_its_windows(monkeypatch):
    """The steal share over two windows is their steal jiffies over their
    total ones; with nothing read it is None."""
    steal, total = bench_torch.steal_jiffies()  # this machine's, unpatched
    assert 0 <= steal <= total
    reads = iter([(10, 1000), (12, 1100), (20, 2000), (23, 2100)])
    monkeypatch.setattr(bench_torch, "steal_jiffies", lambda: next(reads))
    meter = bench_torch.StealMeter()
    for _ in range(2):
        with meter:
            pass
    assert meter.share == pytest.approx(5 / 200)
    monkeypatch.setattr(bench_torch, "steal_jiffies", lambda: (0, 0))
    with bench_torch.StealMeter() as empty:
        pass
    assert empty.share is None


def test_the_existing_cells_resolve_as_before(printed):
    """The new optional fields leave the two benchmark cells as they were: the
    same fields and values, no blend, the constructor's dedup bound."""
    before = {
        CORPUS: {"config": "cl100k_synth", "chips": 1, "entry": "encode_corpus", "routing": "default",
                 "mb": 64.0, "chunk_bytes": 8388608, "repetitions": 9, "warm_up_mb": 0.5,
                 "warm_up_seed": 123},
        STREAM: {"config": "cl100k_synth", "chips": 1, "entry": "encode_batch_stream",
                 "routing": "default", "mb": 8.0, "chunk_docs": 256, "repetitions": 21,
                 "warm_pass": True, "warm_up_mb": 0.5, "warm_up_seed": 123, "k1_tile_width": 8192},
    }
    described = {"name", "command", "traffic", "reduced", "why"}
    for name, fields in before.items():
        assert {k: v for k, v in WORKLOADS[name].items() if k not in described} == fields
    _, lines = printed
    by_cell = {r["cell"]: r for r in lines}
    assert set(by_cell[STREAM]["input"]) == {"bytes", "docs", "chunks", "chunk_docs", "tokens"}
    assert set(by_cell[CORPUS]["input"]) == {"bytes", "docs", "chunks", "chunk_bytes", "tokens"}
    tok = bench_torch.make_tok(BENCH["configs"]["cl100k_synth"], "default", (torch.device("cpu"),))
    assert tok._max_unique_rows == 1 << 20 and tok.mesh is None
    for name in (CORPUS, STREAM):  # one device: no mesh, no per-card field
        assert bench_torch.cell_devices(WORKLOADS[name], "cpu") == (torch.device("cpu"),)
        assert "shards" not in by_cell[name] and "cards" not in by_cell[name]
        assert not [k for k in by_cell[name]["layers"] if k.endswith("_by_card")]
    # The four-card case: the stream cell's traffic over four distinct cards.
    mesh = {w["name"]: w for w in bench_entries.with_cases(BENCH, 21)["workloads"]}[MESH]
    assert {k: v for k, v in mesh.items() if k not in ("name", "entry")} == {
        **{k: before[STREAM][k] for k in bench_entries.KEEP}, "repetitions": 21,
        "chips": 4, "mesh_devices": 4, "k1_tile_width": None}


def _tool(name: str, monkeypatch, args: list) -> dict:
    """Run tools/NAME.py's main at a tiny size on the CPU; its JSON record."""
    import importlib

    from tokenizer_tpu_torch.runtime import native

    require_vocab("cl100k_synth")
    pytest.importorskip("tiktoken")
    monkeypatch.setenv("TOKENIZER_TPU_CACHE_DIR", str(native._cache_dir().parent))  # no new build
    out = Path(args[args.index("--out") + 1])
    with contextlib.redirect_stdout(io.StringIO()):
        assert importlib.import_module(name).main(["--device", "cpu", *args]) == 0
    rec = json.loads(out.read_text())
    assert rec["card"] == "cpu (no card)" and rec["device"] == "cpu"
    return rec


def test_scan_threads_tool_runs_on_cpu(monkeypatch, tmp_path):
    rec = _tool("scan_threads", monkeypatch, ["--mb", "0.05", "--cycles", "1",
                                              "--out", str(tmp_path / "scan.json")])
    assert [p["threads"] for p in rec["split_points"]] == [p["threads"] for p in rec["emit_points"]] \
        == [1, 2, 4, 8]
    assert all(p["MBps"] > 0 for p in rec["split_points"] + rec["emit_points"])
    assert rec["pure_scan_MBps"] > 0 and rec["default_threads"] >= 1
    assert 0 < rec["build_segments_s"] and 0 < rec["split_emit_s"] and 0 < rec["encode_batch_warm_s"]
    # cold: a fresh tokenizer a run, fused and unfused, the counters beside the wall
    cold = rec["cold"]
    assert cold["chunk_docs"] == WORKLOADS[STREAM]["chunk_docs"]
    for arm in ("fused", "unfused"):
        assert [p["threads"] for p in cold[arm]] == [1, 2, 4, 8]
        for p in cold[arm]:
            (r,) = p["runs"]
            c = r["counters"]
            assert p["best_wall_s"] == r["wall_s"] > 0 and list(c) == list(native.SCAN_COUNTERS)
            assert c["calls"] == r["calls"] and c["inserts"] > 0
            fused = c["fused_short"] + c["fused_long"] + c["gen_copies"]
            assert (fused > 0) == (arm == "fused") and (c["defer_off"] > 0) == (arm == "unfused")
    inserts = {p["runs"][0]["counters"]["inserts"] for arm in ("fused", "unfused") for p in cold[arm]}
    assert len(inserts) == 1  # the same first-seen pieces at every thread count, either way
    # fresh: a new context's first and second call, at every thread count
    fresh = rec["fresh"]
    assert 0 < fresh["docs"] <= 16 and [p["threads"] for p in fresh["points"]] == [1, 2, 4, 8]
    assert all(p["first_call_s"] > 0 and p["second_call_s"] > 0 for p in fresh["points"])


def test_overlap_ab_tool_runs_on_cpu(monkeypatch, tmp_path):
    rec = _tool("overlap_ab", monkeypatch, ["--mb", "0.03", "--rounds", "2", "--chunk-docs", "4",
                                            "--warm-up-mb", "0.01", "--out", str(tmp_path / "ab.json")])
    assert rec["mismatched_documents"] == 0 and rec["documents_checked"] == rec["docs"] * 8
    for routing in ("default", "forced"):
        r = rec[routing]
        for arm in ("encode_batch", "encode_batch_stream"):
            assert len(r[arm]["s"]) == 2 and 0 < r[arm]["min_s"] <= r[arm]["median_s"]
        assert r["min_ratio"] > 0 and r["median_ratio"] > 0
    forced = rec["forced"]["encode_batch_stream"]["router"]
    assert forced["device_waves"] > 0 and forced["host_wave_pieces"] == forced["fused_pieces"] == 0
