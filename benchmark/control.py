"""Read a cell's control: the reference put in the program's place and run
in the precision just below the one the configuration states (fp8 for
bf16 features; TF32 for float32 with TF32 off), judged by the cell's own
comparison against the reference at the stated precision.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        [--fault half_batch | --program]

One JSON line per seed, with every number compared and its limit; a
control that passes the cell's limits would make them worthless.
``--fault half_batch`` plants that fault in the reference instead (train:
half of each batch left out, the mean over the rest; serve: the answers of
the batch's second half left at the start pose, as if never solved).
``--program`` reads the program's own numbers, a whole run with a short
window a seed, all seeds in one process: the sound runs the limits are
set above.  Needs a CUDA device; ``--device cpu`` reads it at the sizes a
test gives.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmark.harness import spec  # noqa: E402


def read(cell, seed: int, device, fault: str = None) -> dict:
    """The control's numbers on one seed: a serve cell's sampled answers
    of a window of ``check.calls`` calls, a train cell's first steps; or,
    with ``fault``, the reference at the stated precision with that fault
    planted."""
    from benchmark.harness import check, runner
    runner.numerics(cell.route)
    run = runner.ROUTES[cell.traffic["route"]](cell, seed, device)
    run.make_inputs()
    control = fault or cell.route["control"]
    if cell.traffic["route"] == "train":
        run.first = run.reference(
            cell.traffic["checked_steps"], None if fault else control,
            run.batch // 2 if fault == "half_batch" else None)
        values = run.check()
    else:
        first = cell.traffic["warm_calls"]
        run.outs = [(c, c % run.pool_n, None) for c in
                    range(first, first + cell.traffic["check"]["calls"])]

        def program(p, idx, draws):
            if fault != "half_batch":
                return run.reference(p, idx, draws, control)
            pose = run.reference(p, idx, draws)
            pose[np.asarray(idx) >= run.batch // 2] = 0.0
            return pose
        values = run.check(program)
    ok, rows = check.judge(values, cell.limits)
    return {"workload": cell.name, "seed": seed, "control": control,
            "passes_limits": ok,
            "checks": {k: {"value": v, "limit": lim} for k, v, lim in rows}}


def sound(cell, seed: int, device, seconds: float = 3.0) -> dict:
    """The program's own numbers on one seed: a whole run (set-up, a
    ``seconds`` window, the check), its timing not kept."""
    from benchmark.harness import runner
    r = runner.execute(cell, seed, seconds, False, device,
                       time.perf_counter())
    return {"workload": cell.name, "seed": seed, "control": "program",
            "passes_limits": r["correct"], "checks": r["checks"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=("half_batch",))
    ap.add_argument("--program", action="store_true")
    a = ap.parse_args()
    spec.use_checkout_caches()
    for seed in a.seeds:
        cell = spec.resolve(a.workload)
        r = (sound(cell, seed, a.device) if a.program
             else read(cell, seed, a.device, a.fault))
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
