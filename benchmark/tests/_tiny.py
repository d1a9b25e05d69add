"""Cells of the benchmark at sizes a CPU test holds: the published
structure (three levels, both branches, every round's kind), small maps."""

from benchmark.harness import spec

TINY = dict(sat_size=128, grd_h=64, grd_w=256, N_iters=2)


def tiny_cell(workload: str, root=spec.ROOT) -> spec.Cell:
    cell = spec.resolve(workload, root)
    cell.config["model"].update(TINY)
    cell.traffic.update(batch=4, check_rows=2, warm_calls=1, trace_calls=2)
    if "check" in cell.traffic:
        cell.traffic["check"] = {"calls": 2, "images": 3}
    return cell


def workloads(route=None):
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]
            if route is None or spec.resolve(w["name"]).traffic["route"]
            == route]
