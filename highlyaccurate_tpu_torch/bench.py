"""The port's benchmark (port of the repository's ``bench.py``): thirteen
metrics of serving and training throughput and latency on the GPU.

    python -m highlyaccurate_tpu_torch.bench               # on the GPU
    python -m highlyaccurate_tpu_torch.bench --device cpu  # CPU smoke shapes
    python -m highlyaccurate_tpu_torch.bench --metric NAME [--device cpu]

Prints JSON lines of ``bench.py``'s contract, {"metric", "value", "unit",
"vs_baseline", "extra"}: the headline is KITTI LM_S2GP serving in
frames/s (batch 32, level 3, N_iters 5, bf16 features), printed the moment
its child finishes, and a final line at the end.  ``extra`` holds the
twelve other metrics under ``bench.py``'s names and ``device``, the card's
name and power limit as ``nvidia-smi`` reports them.  ``vs_baseline`` is
the value over 2.86 frames/s, ``bench.py``'s estimate of the reference's
batch-1 rate on a consumer GPU of the paper's era.

Each metric runs in a child process of its own (``--metric NAME``) with a
deadline; the parent imports no model code and creates no CUDA context, so
each child has the whole card.  The first GPU child builds the kernels
(``ops/_build.py``, into ``build/kernels/``) inside its deadline.  A child
checks the kernel launches of its path against ``Spec.launches`` (on the
CPU: none) and fails on a mismatch, so no number comes from a path that
skipped its kernel.  A watchdog prints a parseable line by
``_BENCH_FLUSH_S`` even while the headline's child hangs.

Unlike ``bench.py`` it serves no cached number and never falls back: there
is no ``.bench_cache.json``, no run on the host when the card is missing,
and no retry of a failed banded path on the gather sampler.  Any of those
would put a number under a metric's name that the metric's path did not
measure.  A metric that fails, times out or is skipped for the budget
reads ``"error: <why>"`` in ``extra``; a headline that never lands reads
value 0 and ``[FAILED: <why>]``; either way the parent exits 1 after its
last line.  Without a GPU and without ``--device cpu`` the parent prints a
FAILED line, starts no child and exits 1.  A child that reports another
device than the one asked for is refused.

Timing: one warm-up call, then a window of n calls between two
``torch.cuda.synchronize()`` (``bench.py``'s n: 30 for the headline,
``3 * 10`` or 10 for the other evaluations, 10 train steps where one takes
under 2 s, else 3), on inputs already on the device.  Each call seeds the
solver's generator with its index (``bench.py``'s ``fold_in(key, i)``).
The tracking metric feeds each call's pose to the next as its
``init_pose``.  Convolutions and matrix products run in fp32 (TF32 off).

Env knobs (seconds): _BENCH_FLUSH_S (420), _BENCH_FLAGSHIP_TIMEOUT_S
(2400), _BENCH_METRIC_TIMEOUT_S (900), _BENCH_TOTAL_S (7200).
``_BENCH_ONLY="name1,name2"`` restricts the extras (``""``: none);
``_BENCH_FAKE_HANG="name,..."`` makes those children sleep (tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.utils.device import resolve_device

REF_GPU_BATCH1_FPS = 2.86
MARKER = "##BENCH##"
ROOT = Path(__file__).resolve().parents[1]
HEADLINE = "KITTI LM_S2GP end-to-end inference frames/sec/chip"
EXTRAS = ("bf16_b8_eval_fps", "fp32_eval_fps", "train_fps",
          "bf16_train_fps", "gather_eval_fps", "g2sp_eval_fps",
          "g2sp_train_fps", "multihyp4_eval_fps", "ford_eval_fps",
          "ford_train_fps", "batch1_latency_ms",
          "tracking_warm2_b1_latency_ms")
METRICS = ("flagship",) + EXTRAS
# bench.py's Ford rig (camera -> body quaternion w, x, y, z, translation
# in meters; the patch is 0.22 m a pixel)
FORD_QVEC = (0.997, 0.01, 0.05, 0.02)
FORD_T_FL = (1.0, 0.5, -1.4)
# (lat, lon, theta) -> the model's normalized pose order, which init_pose
# takes: KITTI's u is longitudinal, Ford's lateral
POSE_ORDER = {"S2GP": (1, 0, 2), "G2SP": (1, 0, 2), "Ford": (0, 1, 2)}


@dataclasses.dataclass(frozen=True)
class Spec:
    """One metric: the family ("S2GP", "G2SP" or "Ford") and its config,
    the batch, the calls of the timed window (None: a train step's 10 or
    3), the kernel launches of one call on the card, and whether a call is
    a train step, whether it warm-starts from the previous call's pose, and
    whether the metric is ms per frame (else frames/s)."""
    family: str
    cfg: Config
    batch: int
    n: Optional[int]
    launches: dict
    train: bool = False
    warm: bool = False
    latency: bool = False


def flagship_cfg(device: str):
    """(batch, config) of the headline on ``device`` ("cuda" or "cpu"):
    ``bench.py``'s production evaluation config on the card, its smoke
    shapes on the host."""
    if device == "cuda":
        return 8, Config(level=3, N_iters=5, compute_dtype="bfloat16")
    return 2, Config(level=-1, N_iters=2, grd_h=32, grd_w=128, sat_size=64,
                     use_banded_warp=0)


def specs(device: str) -> dict:
    """name -> ``Spec`` of every metric on ``device`` (``bench.py``'s
    configurations and batches)."""
    batch, bf16 = flagship_cfg(device)
    fp32 = dataclasses.replace(bf16, compute_dtype="float32")
    g2sp = dataclasses.replace(fp32, direction="G2SP")
    gpu = device == "cuda"
    n = 10 if gpu else 2
    k1, samplers = {"k1": 15}, {"k2": 15, "k3": 15}
    return {
        "flagship": Spec("S2GP", bf16, 32 if gpu else batch,
                         30 if gpu else 3, k1),
        "bf16_b8_eval_fps": Spec("S2GP", bf16, batch, 3 * n, k1),
        "fp32_eval_fps": Spec("S2GP", fp32, batch, 3 * n, k1),
        "train_fps": Spec("S2GP", fp32, batch, None, samplers, train=True),
        "bf16_train_fps": Spec("S2GP", bf16, batch, None, samplers,
                               train=True),
        "gather_eval_fps": Spec(
            "S2GP", dataclasses.replace(fp32, use_banded_warp=0), batch, n,
            {}),
        "g2sp_eval_fps": Spec("G2SP", g2sp, batch, n, {"k4": 15, "k7": 15}),
        "g2sp_train_fps": Spec(
            "G2SP", dataclasses.replace(g2sp, remat=1), batch, None,
            {"k4": 15, "k5": 15}, train=True),
        "multihyp4_eval_fps": Spec(
            "S2GP", dataclasses.replace(fp32, pose_hypotheses=4), batch, n,
            k1),
        "ford_eval_fps": Spec("Ford", fp32, batch, n, k1),
        "ford_train_fps": Spec("Ford", fp32, batch, None, samplers,
                               train=True),
        "batch1_latency_ms": Spec("S2GP", fp32, 1, 3 * n, k1, latency=True),
        "tracking_warm2_b1_latency_ms": Spec(
            "S2GP", dataclasses.replace(fp32, N_iters=2), 1, 3 * n,
            {"k1": 6}, warm=True, latency=True),
    }


@dataclasses.dataclass
class Workload:
    """A metric's model on its device, its inputs (images on the device,
    then camera_k or the Ford rig, which stays on the host for the kernel
    layout) and ``call(i, prev)``: the i-th call, which returns the
    normalized pose [B, 3] in the model's order (evaluation) or the step's
    loss (training); ``prev`` is the previous call's return, or ``start``
    for the first (the tracking loop's zero pose; None elsewhere)."""
    model: torch.nn.Module
    inputs: tuple
    call: Callable
    start: Optional[torch.Tensor] = None


def build(spec: Spec, device, state_dict: Optional[dict] = None) -> Workload:
    """The workload of ``spec`` on ``device``: weights drawn by
    ``init_params`` from a generator seeded 0, or ``state_dict``; images
    from ``np.random.RandomState(0)`` as ``bench.py`` draws them."""
    from highlyaccurate_tpu_torch.geometry.ford import qvec2rotmat
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import (LMS2GP,
                                                         _scaled_default_k)
    from highlyaccurate_tpu_torch.params import init_params
    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import (make_eval_step,
                                                     make_train_step)

    device = torch.device(device)
    cfg, B = spec.cfg, spec.batch
    family = {"S2GP": LMS2GP, "G2SP": LMG2SP, "Ford": LMS2GPFord}
    model = family[spec.family](cfg, device=device)
    if state_dict is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    rng = np.random.RandomState(0)
    A = cfg.sat_size
    inputs = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.rand(B, A, A, 3), rng.rand(B, cfg.grd_h, cfg.grd_w, 3)))
    side_m = None
    if spec.family == "G2SP":
        # bench.py's K is the default K of a 1024 x 256 input; scaled to
        # the input, as bench.py does not on its CPU shapes (there its
        # principal point leaves the 128 x 32 image and no pose moves)
        k = _scaled_default_k(cfg)
        inputs += (torch.from_numpy(k).expand(B, 3, 3).contiguous()
                   .to(device),)
    elif spec.family == "Ford":
        side_m = A * 0.22
        R = torch.from_numpy(qvec2rotmat(FORD_QVEC).astype(np.float32))
        inputs += (R.expand(B, 3, 3).contiguous(),
                   torch.tensor(FORD_T_FL).expand(B, 3).contiguous())
    gen = torch.Generator(device=device)

    if spec.train:
        state = create_train_state(cfg, model)
        step = make_train_step(model, cfg, ford_side_m=side_m)
        gt = torch.zeros(B, 3, device=device)

        def train_call(i, prev):
            nonlocal state
            state, metrics = step(state, *inputs, gt, gen.manual_seed(i))
            return metrics["loss"]

        return Workload(model, inputs, train_call)

    step = make_eval_step(model, cfg, ford_side_m=side_m,
                          warm_start=spec.warm)
    order = POSE_ORDER[spec.family]

    def eval_call(i, prev):
        init = (prev,) if spec.warm else ()
        out = step(*inputs, *init, gen.manual_seed(i))
        return torch.stack([out[j] for j in order], -1)

    start = torch.zeros(B, 3, device=device) if spec.warm else None
    return Workload(model, inputs, eval_call, start)


def _window(name: str, spec: Spec, w: Workload, seeds, device) -> float:
    """Seconds of the calls ``seeds`` between two synchronizations, each
    fed the previous call's return; fails unless every kernel launched as
    ``spec`` says per call (on the CPU: none) and the last return is
    finite."""
    from highlyaccurate_tpu_torch import ops

    ops.reset_launches()
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = w.start
    for i in seeds:
        out = w.call(i, out)
    sync()
    seconds = time.perf_counter() - t0
    per_call = spec.launches if device.type == "cuda" else {}
    ops.expect_launches(f"{name}: {len(seeds)} calls",
                        {k: v * len(seeds) for k, v in per_call.items()})
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{name}: non-finite output {out}")
    return seconds


def measure(name: str, spec: Spec, w: Workload, device) -> float:
    """The metric: frames/s, or ms per frame where ``spec.latency``, over
    one window after a warm-up call (``bench.py``'s seeds: 0 for the
    warm-up, 99 for a train step's one-call probe that picks n, i for the
    window's i-th call)."""
    _window(name, spec, w, [0], device)
    n = spec.n
    if n is None:
        n = 10 if _window(name, spec, w, [99], device) < 2.0 else 3
    fps = spec.batch * n / _window(name, spec, w, range(n), device)
    return 1e3 / fps if spec.latency else fps


def child_main(metric: str, device_arg: Optional[str]) -> None:
    """``--metric NAME``: measure one metric and print it on a line
    ``MARKER {"name", "value", "device"}``."""
    if metric in os.environ.get("_BENCH_FAKE_HANG", "").split(","):
        time.sleep(3600)  # test hook: a child that never answers
    device = resolve_device(device_arg)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        from highlyaccurate_tpu_torch.ops import _build
        _build.build()
    spec = specs(device.type)[metric]
    value = measure(metric, spec, build(spec, device), device)
    print(f"{MARKER} " + json.dumps(
        {"name": metric, "value": round(float(value), 2),
         "device": device.type}), flush=True)


# ---------------------------------------------------------------------------
# the parent: no model code, no CUDA context
# ---------------------------------------------------------------------------


def _env_s(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def _run_child(metric: str, timeout_s: float, device_args: list):
    """Run one ``--metric`` child in a process group of its own (so a
    timeout also stops the compilers it started); (value, device) or
    (None, why)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "highlyaccurate_tpu_torch.bench", "--metric",
         metric, *device_args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return None, f"timeout after {timeout_s:.0f}s"
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    sys.stderr.write(err)
    for line in reversed(out.splitlines()):
        if line.startswith(MARKER):
            d = json.loads(line[len(MARKER):])
            return d["value"], d["device"]
    last = [ln for ln in err.splitlines() if ln.strip()][-1:]
    return None, (f"exit {proc.returncode}, no result line"
                  + (f" ({last[0].strip()[:300]})" if last else ""))


def smi_index() -> str:
    """``nvidia-smi -i``'s name for the card the children see as device 0:
    the first entry of ``CUDA_VISIBLE_DEVICES`` (an index or a UUID) where
    it is set, else 0 (nvidia-smi itself ignores that variable)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0]
    return visible.strip() or "0"


def device_info(device: torch.device) -> dict:
    """{"name", "power_limit"} of the children's card as ``nvidia-smi``
    reports them (no CUDA context); the host CPU has no power limit to
    report."""
    if device.type == "cpu":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "-i", smi_index(), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


class Scoreboard:
    """Thread-safe results and the contract's line: the watchdog thread
    and the main thread print through one lock, so no line mixes a
    half-updated state."""

    def __init__(self, desc: str):
        self._lock = threading.Lock()
        self.flagship = None  # the headline's value, once measured
        self.why = "flagship did not complete"
        self.extra = {}
        self.desc = desc

    def _line_locked(self) -> str:
        value = self.flagship or 0.0
        suffix = "" if self.flagship is not None else f" [FAILED: {self.why}]"
        return json.dumps({
            "metric": f"{HEADLINE} ({self.desc}){suffix}",
            "value": round(float(value), 2),
            "unit": "frames/sec",
            "vs_baseline": round(float(value) / REF_GPU_BATCH1_FPS, 2),
            "extra": dict(self.extra),
        })

    def set_flagship(self, value: float):
        """Set the headline and print a complete line, atomically."""
        with self._lock:
            self.flagship = value
            print(self._line_locked(), flush=True)

    def set_extra(self, name: str, value):
        with self._lock:
            self.extra[name] = value

    def flush_if_missing(self, why: str):
        """The watchdog: if no headline landed yet, print a FAILED line."""
        with self._lock:
            if self.flagship is None:
                self.why = why
                print(self._line_locked(), flush=True)

    def emit(self, why: Optional[str] = None):
        with self._lock:
            if why is not None:
                self.why = why
            print(self._line_locked(), flush=True)

    def failed(self) -> bool:
        with self._lock:
            return self.flagship is None or any(
                isinstance(v, str) and v.startswith("error")
                for v in self.extra.values())


def parent_main(device_arg: Optional[str]) -> int:
    """Run the headline's child, then each extra's; print the contract's
    lines; 0 when every metric measured, else 1."""
    t_start = time.monotonic()
    flush_s = _env_s("_BENCH_FLUSH_S", 420)
    flagship_timeout = _env_s("_BENCH_FLAGSHIP_TIMEOUT_S", 2400)
    metric_timeout = _env_s("_BENCH_METRIC_TIMEOUT_S", 900)
    total_s = _env_s("_BENCH_TOTAL_S", 7200)
    only = os.environ.get("_BENCH_ONLY")  # "" selects no extras
    names = (list(EXTRAS) if only is None
             else [m for m in only.split(",") if m])
    unknown = [m for m in names if m not in EXTRAS]
    if unknown:
        print(f"bench: unknown metrics in _BENCH_ONLY: {unknown}",
              file=sys.stderr)
        return 2

    board = Scoreboard(
        "batch 2, level -1, N_iters 2, CPU smoke shapes on the host, not a "
        "device number" if device_arg == "cpu" else
        "batch 32, level 3, N_iters 5, bf16 features")
    try:
        device = resolve_device(device_arg)
        board.set_extra("device", device_info(device))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        # no card: nothing runs, on the card or on the host
        why = f"{type(e).__name__}: {e}"
        for name in names:
            board.set_extra(name, f"error: not run ({why})")
        board.emit(why)
        return 1
    # a child reports its device type; ask for exactly that one
    device_args = ["--device", device.type]

    def _signal_exit(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _signal_exit)
    watchdog = threading.Timer(
        flush_s, board.flush_if_missing,
        (f"flagship did not complete by the watchdog deadline "
         f"({flush_s:.0f}s)",))
    watchdog.daemon = True
    watchdog.start()
    try:
        value, info = _run_child("flagship", flagship_timeout, device_args)
        if value is not None and info != device.type:
            value, info = None, f"child ran on {info}, not {device.type}"
        if value is None:
            print(f"bench: flagship failed ({info})", file=sys.stderr)
            board.emit(f"flagship failed: {info}")
        else:
            board.set_flagship(value)  # the moment its child finishes

        for name in names:
            left = total_s - (time.monotonic() - t_start)
            if left < 60:
                board.set_extra(name,
                                "error: skipped: total budget exhausted")
                continue
            value, info = _run_child(name, min(metric_timeout, left),
                                     device_args)
            if value is not None and info != device.type:
                value, info = None, f"child ran on {info}, not {device.type}"
            if value is None:
                print(f"bench: {name} failed ({info})", file=sys.stderr)
                board.set_extra(name, f"error: {info}")
            else:
                board.set_extra(name, value)
    finally:
        watchdog.cancel()
    board.emit()
    return 1 if board.failed() else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m highlyaccurate_tpu_torch.bench",
        description="The port's benchmark: bench.py's metrics on the GPU.")
    p.add_argument("--metric", choices=METRICS,
                   help="measure this one metric (a child of the run)")
    p.add_argument("--device", choices=("cuda", "cpu"),
                   help="default cuda; cpu runs the smoke shapes on the host")
    args = p.parse_args(argv)
    if args.metric is not None:
        child_main(args.metric, args.device)
        return 0
    return parent_main(args.device)


if __name__ == "__main__":
    sys.exit(main())
