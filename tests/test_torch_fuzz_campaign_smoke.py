"""Keep tools/fuzz_campaign_torch.py importable and its iteration bodies
healthy: three iterations of each of encode, trim, threads and mesh on
the CPU (``--device cpu``: the plain merge, and eight ``cpu`` shards for
the mesh), each against the port's host engine, exactly."""

from __future__ import annotations

import random
import sys
from pathlib import Path

import pytest

from conftest import require_vocab

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.mark.parametrize("mode", ["encode", "trim", "threads", "mesh"])
def test_campaign_iterations_smoke(mode):
    for enc in ("gpt2", "cl100k_synth", "o200k_synth"):
        require_vocab(enc)
    import fuzz_campaign_torch

    rng = random.Random({"encode": 1234, "trim": 1234, "threads": 1234, "mesh": 4321}[mode])
    step = fuzz_campaign_torch.STEPS[mode]
    for _ in range(3):
        step(rng, "cpu")
    if mode == "mesh":
        assert fuzz_campaign_torch.mesh_devices("cpu") == ["cpu"] * 8
        assert all(t.mesh.size == 8 for t in fuzz_campaign_torch._MESH_TOKS.values())


def test_campaign_run_reports_a_mismatch(monkeypatch):
    require_vocab("gpt2")
    import fuzz_campaign_torch

    def broken(rng, device):
        assert False, ("batch", "some text")

    monkeypatch.setitem(fuzz_campaign_torch.STEPS, "encode", broken)
    its, failure = fuzz_campaign_torch.run("encode", 7, 5.0, "cpu")
    assert its == 1 and failure.startswith("MISMATCH at iter 1 seed 7 mode encode")
    assert fuzz_campaign_torch.main(["encode", "7", "5", "--device", "cpu"]) == 1
