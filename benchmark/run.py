"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``highlyaccurate_tpu_torch``)
and ``BENCHMARK.json``.  The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` (traced runs)
and, last, ``checks``: each number compared with its limit, which also
end standard error.  Exits non-zero, with no result, without enough CUDA
devices, without the port, or if JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.harness import spec  # noqa: E402

spec.use_checkout_caches()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()

    cell = spec.resolve(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    try:
        import highlyaccurate_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is not in this checkout ({e})",
              file=sys.stderr)
        return 4
    from benchmark.harness import runner
    result = runner.execute(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                            T_START)
    bad = runner.forbidden_modules(list(sys.modules))
    if bad:
        print(f"benchmark: loaded {bad}, which the port must not load",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
