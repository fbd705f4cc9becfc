"""A fixture for the port's heavier CPU test files: one torch intra-op
thread while the module runs.  Their tensors are small, and under the
tier-1 command's six xdist workers on eight cores more threads a worker
only starve the other files, the JAX package's wall-clock tests
(``tests/test_elastic_backends.py``) among them.  A module takes it with
``from torch_threads import few_threads  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
