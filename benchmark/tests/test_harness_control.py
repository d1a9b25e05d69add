"""Each cell's control fails the cell's limits: the reference put in the
program's place one precision below the configuration's (fp8 for bf16
features, on the CPU at a tiny size; TF32 for float32, which only the card
has, at the cell's own size), and the planted fault of half of each
batch left out (training: the mean over the rest; serving: left at the
start pose)."""

import pytest
import torch

from benchmark import control
from benchmark.harness import spec
from benchmark.tests._tiny import tiny_cell, workloads


def controlled(precision):
    return [w for w in workloads()
            if spec.resolve(w).route["control"] == precision]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", controlled("fp8"))
def test_the_fp8_control_fails(workload):
    assert not control.read(tiny_cell(workload), 7, "cpu")["passes_limits"]


@pytest.mark.parametrize("workload", workloads())
def test_half_the_batch_fails(workload):
    r = control.read(tiny_cell(workload), 7, "cpu", "half_batch")
    assert not r["passes_limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", controlled("tf32"))
def test_the_tf32_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    r = control.read(spec.resolve(workload), 3000000501, "cuda")
    assert not r["passes_limits"], r["checks"]
