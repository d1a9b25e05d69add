"""One run of one cell: set-up, the timed or the traced window, the peak
memory, and the check against the reference once the program is freed."""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness import check, spec, trace
from benchmark.harness.serve import Serve
from benchmark.harness.train import Train

ROUTES = {"serve": Serve, "train": Train}
FORBIDDEN = ("jax", "jaxlib", "flax", "highlyaccurate_tpu")


def log(msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def numerics(route: dict):
    """torch's TF32 flags as the deployment sets them (the program sets
    none itself)."""
    torch.backends.cudnn.allow_tf32 = bool(route["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(route["matmul_allow_tf32"])


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one the benchmark must
    not load (the JAX package or JAX), compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in modules}
                  & set(FORBIDDEN))


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float) -> dict:
    """The result of one run (the result line's keys, ``checks`` last)."""
    numerics(cell.route)
    run = ROUTES[cell.traffic["route"]](cell, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s, {run.phases}")
    if traced:
        # the same calls untraced first: the step's time without the
        # profiler's own cost, which ``mfu.*`` divides by
        n = cell.traffic["trace_calls"]
        t0 = time.perf_counter()
        run.window(calls=n)
        call_s = (time.perf_counter() - t0) / n
        with trace.profiled() as prof:
            with torch.profiler.record_function(trace.WINDOW):
                stats = run.window(calls=n)
        tr = trace.reduce(prof, stats["calls"])
        tr.call_s = call_s
    else:
        stats = run.window(seconds=seconds)
    if getattr(run, "latencies", None):
        log("latency ms " + " ".join(f"{x * 1e3:.1f}"
                                     for x in run.latencies))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.release()
    t0 = time.perf_counter()
    values = run.check()
    log(f"check {time.perf_counter() - t0:.3f} s")
    correct, rows = check.judge(values, cell.limits)
    result = {"correct": correct and not stats["failed"],
              "attempted": stats["attempted"],
              "failed": stats["failed"]}
    if traced:
        tr.model, tr.route, tr.traffic, tr.reference = (
            cell.config["model"], cell.route, cell.traffic, cell.reference)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        stats["setup_s"] = setup_s
        metrics = {m["name"]: {"value": stats[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info(device, cell.chips, peak)
    if traced:
        result["device"].update(busy_s=tr.busy_us / 1e6,
                                window_s=tr.window_us / 1e6)
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def device_info(device, chips: int, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak,
            "power_limit_w": power_limit()}


def power_limit():
    """The card's power limit in watts, as nvidia-smi reads it (None where
    it cannot)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None

