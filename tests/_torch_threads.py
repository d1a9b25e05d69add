"""A fixture for the port's CPU parity tests: one torch intra-op thread
per test.  The suite runs six workers on the machine's cores; torch's
OpenMP threads then spin against each other on the many small operations
of the solver rounds and the CLI runs (a tiny CLI training run took 16x
longer under that load with the default thread count than with one).
Import ``one_torch_thread`` into a test module to apply it to every test
there."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
