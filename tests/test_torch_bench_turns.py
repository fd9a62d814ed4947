"""``tools/bench_turns.py``: the comparison of two trees' bench_torch.py
records, on records made up here (the runs themselves need a card)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import bench_turns  # noqa: E402


def _record(cell, cold, warm, control, waves, oracle_s, seed=0):
    def samples(xs):
        return {"median": sorted(xs)[len(xs) // 2], "samples": xs}

    return {"cell": cell, "seed": seed, "metrics": {"cold_MBps": samples(cold), "warm_MBps": samples(warm)},
            "control_MBps": samples(control),
            "router": [{"device_waves": w, "host_fallback_pieces": 384, "device_blocking_s": 0.1}
                       for w in waves],
            "layers": {"traced_wall_s": 0.2, "device_busy_us": None, "device_idle_share": 0.999,
                       "k1_device_us": 101.0,
                       "host_s": {"_finish_span_rows": 0.1, "_oracle_piece": oracle_s}}}


CELL = "cl100k_synth-stream-8mb"


def _runs(seed=0):
    """One round, in the tool's order: parent, change, change, parent."""
    return [
        {"side": "parent", "record": _record(CELL, [40.0, 42.0, 44.0], [270.0] * 3, [120.0] * 3, [6, 6, 6], 0.08, seed)},
        {"side": "change", "record": _record(CELL, [55.0, 56.0, 60.0], [271.0] * 3, [119.0] * 3, [6, 6, 7], 0.0, seed)},
        {"side": "change", "record": _record(CELL, [41.0, 41.5, 42.0], [269.0] * 3, [121.0] * 3, [6, 6, 6], 0.0, seed)},
        {"side": "parent", "record": _record(CELL, [43.0, 44.0, 45.0], [272.0] * 3, [118.0] * 3, [6, 6, 6], 0.09, seed)},
    ]


def test_summary_pairs_quartiles_and_router():
    (s,) = bench_turns.summarize(_runs()).values()
    cold = s["metrics"]["cold_MBps"]
    assert cold["pairs"] == 2 and cold["change_wins"] == 1  # 56 > 42, then 41.5 < 44
    assert cold["parent"]["n"] == cold["change"]["n"] == 6
    assert cold["parent"]["invocation_medians"] == [42.0, 44.0]
    assert cold["change"]["invocation_medians"] == [56.0, 41.5]
    assert cold["parent"]["median"] == pytest.approx(43.5)
    assert cold["ratio"] == pytest.approx(cold["change"]["median"] / 43.5)
    assert set(s["metrics"]) == {"cold_MBps", "warm_MBps", "control_MBps"}
    assert s["router"]["parent"]["device_waves"] == {"6": 6}
    assert s["router"]["change"]["device_waves"] == {"6": 5, "7": 1}
    assert s["router"]["change"]["device_blocking_s"] == {"median": 0.1}
    assert s["traced"]["parent"]["host_s"]["_oracle_piece"] == [0.08, 0.09]
    assert s["traced"]["change"]["host_s"]["_oracle_piece"] == [0.0, 0.0]
    assert s["traced"]["change"]["device_busy_us"] is None


def test_summary_takes_files_together_by_cell_and_seed(tmp_path, capsys):
    """A cut file's unpaired last invocation counts in no pair and no
    median; files of one cell and seed pool, another seed stays apart."""
    cut = _runs() + _runs()[:1]
    s = bench_turns.summarize(cut, _runs(), _runs(seed=1))
    assert sorted(s) == [f"{CELL} seed 0", f"{CELL} seed 1"]
    cold = s[f"{CELL} seed 0"]["metrics"]["cold_MBps"]
    assert cold["pairs"] == 4 and cold["change_wins"] == 2
    assert cold["parent"]["n"] == cold["change"]["n"] == 12
    assert s[f"{CELL} seed 1"]["metrics"]["cold_MBps"]["pairs"] == 2
    files = []
    for i, runs in enumerate((cut, _runs())):
        files.append(tmp_path / f"turns{i}.json")
        files[-1].write_text(json.dumps({"runs": runs}))
    assert bench_turns.main(["--summary", *map(str, files)]) == 0
    text = capsys.readouterr().out
    assert f"{CELL} seed 0 cold_MBps: parent median 43.500" in text
    assert "change won 2 of 4 pairs" in text


def test_refuses_trees_whose_benchmark_differs(tmp_path, capsys):
    for f in ("bench_torch.py", "BENCHMARK.json"):
        (tmp_path / f).write_bytes((REPO / f).read_bytes())
    (tmp_path / "BENCHMARK.json").write_text("{}")
    rc = bench_turns.main(["--parent", str(tmp_path), "--cell", "cl100k_synth-stream-8mb"])
    assert rc == 2
    assert "BENCHMARK.json differs" in capsys.readouterr().err
