"""Helpers of the port's CPU parity tests (imported by them; not a test file)."""

import pytest
import torch


def forced(tok):
    """Every wave of ``tok`` onto the merge, however small: on the CPU the
    plain PyTorch merge, as the JAX bench forces its device route."""
    tok._host_pp = float("inf")
    tok._host_wave_max = 0
    return tok


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while the importing module runs.  The plain
    merge is a loop of small tensor ops; with every xdist worker's thread
    pool on the same cores, each op waits on the others' spinning threads
    (a forced 0.5 MB batch measured 2 s alone and 211 s among six
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
