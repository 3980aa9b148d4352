"""Failure detection of the port (abc_tpu_torch.parallel.failure): the cases
of tests/test_failure.py, the barrier over a LocalComm mesh of 8 shards (the
reference's 8 virtual devices); the barrier over a gloo world of spawned
ranks runs in tests/test_torch_multihost.py.
"""

import time

import pytest

from abc_tpu_torch.parallel.failure import DeadlineExceeded, barrier, deadline
from abc_tpu_torch.parallel.sharding import make_mesh


def test_deadline_passes_fast_block():
    with deadline(5.0):
        x = sum(range(1000))
    assert x == 499500


def test_deadline_raises_on_hang():
    with pytest.raises(DeadlineExceeded):
        with deadline(0.2):
            time.sleep(2.0)


def test_barrier_counts_devices():
    assert barrier(timeout=60.0, mesh=make_mesh(dp=2, limb=4,
                                                device="cpu")) == 8


def test_barrier_without_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        barrier(timeout=5.0)


@pytest.mark.gpu
def test_barrier_on_a_mesh_of_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert barrier(timeout=60.0, mesh=make_mesh(dp=2, limb=4,
                                                device="cuda")) == 8
