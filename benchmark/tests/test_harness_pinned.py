"""The harness reads what it read before the answers that differ by model
family moved into the reference modules: every number compared by whole
tiny runs of each cell on the CPU (two seeds; a window of one call or
step), the FLOPs those runs count, and the hand kernels' bytes at the
cells' full sizes.  The values are pinned from a run of the harness at
commit 34637d0, where it still chose a family by the configuration's
direction (PyTorch on the CPU, two threads); the two must agree bit for
bit."""

import time

import pytest
import torch

from benchmark.harness import counts, runner, spec
from benchmark.tests._tiny import tiny_cell

CHECKS = {
    ("s2gp-serve-b128", 2147483749): {
        "pose_gap_max": 0.00015929341316223145,
        "pose_gap_p90": 0.00013080239295959473,
        "pose_gap_p75": 8.806586265563965e-05,
        "pose_gap_median": 1.683831214904785e-05,
    },
    ("s2gp-serve-b128", 3000000777): {
        "pose_gap_max": 0.0013024285435676575,
        "pose_gap_p90": 0.001044624298810959,
        "pose_gap_p75": 0.000657917931675911,
        "pose_gap_median": 1.3407319784164429e-05,
    },
    ("s2gp-train-b16", 2147483749): {
        "feat_gap": 0.0,
        "loss1_gap": 8.041467808381315e-05,
        "loss_gap": 0.0015679098064943508,
        "grad_gap_median": 0.0005734973176920659,
        "step_gap": 0.012112445901168011,
    },
    ("s2gp-train-b16", 3000000777): {
        "feat_gap": 0.0,
        "loss1_gap": 5.329908401038562e-06,
        "loss_gap": 0.0012312354703217826,
        "grad_gap_median": 6.271688927392776e-05,
        "step_gap": 0.009171982008371396,
    },
    ("g2sp-serve-b128", 2147483749): {
        "pose_gap_max": 1.0579824447631836e-06,
        "pose_gap_p90": 1.0445713996887206e-06,
        "pose_gap_p75": 1.0244548320770264e-06,
        "pose_gap_median": 9.909272193908691e-07,
    },
    ("g2sp-serve-b128", 3000000777): {
        "pose_gap_max": 6.430596113204956e-05,
        "pose_gap_p90": 5.162768065929413e-05,
        "pose_gap_p75": 3.261025995016098e-05,
        "pose_gap_median": 9.145587682723999e-07,
    },
    ("s2gp-faithful-serve-b32", 2147483749): {
        "pose_gap_max": 7.450580596923828e-08,
        "pose_gap_p90": 6.556510925292969e-08,
        "pose_gap_p75": 5.21540641784668e-08,
        "pose_gap_median": 2.9802322387695312e-08,
    },
    ("s2gp-faithful-serve-b32", 3000000777): {
        "pose_gap_max": 1.1920928955078125e-07,
        "pose_gap_p90": 1.1175870895385742e-07,
        "pose_gap_p75": 1.0058283805847168e-07,
        "pose_gap_median": 8.195638656616211e-08,
    },
}
FLOPS = {
    "s2gp-serve-b128": 68164780032.0,
    "s2gp-train-b16": 204494340096.0,
    "g2sp-serve-b128": 68164780032.0,
    "s2gp-faithful-serve-b32": 68164780032.0,
}
@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,seed", sorted(CHECKS))
def test_a_tiny_run_reads_as_before(workload, seed):
    cell = tiny_cell(workload)
    r = runner.execute(cell, seed, 0.0, False, "cpu", time.perf_counter())
    assert {k: c["value"] for k, c in r["checks"].items()} == \
        CHECKS[workload, seed]
    assert counts.model_flops(cell.config["model"], cell.traffic["batch"],
                              cell.traffic["route"] == "train") == \
        FLOPS[workload]


def test_the_full_size_bytes_read_as_before():
    """K1, K3 and K4's bytes a call or step at the cells' own sizes."""
    def cell(workload):
        c = spec.resolve(workload)
        return ({**c.config["model"], **c.route}, c.traffic["batch"],
                c.reference)
    serve, train, g2sp = (cell(w) for w in (
        "s2gp-serve-b128", "s2gp-train-b16", "g2sp-serve-b128"))
    assert counts.k1_bytes(*serve) == 10198753280.0
    assert counts.k3_bytes(*train[:2]) == 5872312320.0
    assert counts.k4_bytes(*g2sp) == 50259886080.0
