"""The port's CPU tests run torch on at most two intra-op threads.

The suite runs in several worker processes at once (pytest-xdist, six of
them in ROADMAP.md's Tier-1 command). Each torch process starts an OpenMP
team of one thread a core, so six workers on an eight-core machine run
forty-eight spinning threads, and torch-heavy tests then took three to
thirteen times their time alone (the training loop's 11 s took 142 s).
Every test module of the port imports the autouse fixture below, which sets
two threads for its tests and restores the count after them; the processes
those tests spawn set ``OMP_NUM_THREADS`` themselves.
"""

import pytest
import torch

#: torch's intra-op threads in a port test module
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)


def test_port_tests_run_torch_on_at_most_two_threads():
    assert 1 <= torch.get_num_threads() <= THREADS
    x = torch.randn(256, 256)
    assert torch.equal(x @ x, x @ x)
