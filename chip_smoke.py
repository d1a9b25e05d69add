#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (highlyaccurate_tpu_torch) on one GPU.

    python3 chip_smoke.py              # from the repository root

Builds the hand-written kernels from the sources in the checkout, then:

1. kernels: K1 (``banded_moments``) at each flagship launch shape (KITTI
   S2GP, 512x512 satellite, 256x1024 ground, level=3, batch 8), lines from
   ``s2gp_uv_jac`` at random in-range poses, against its plain PyTorch
   version on the card; kernel and plain times (CUDA events, warmed up, L2
   flushed before every launch, as the solver finds the map cold) beside
   the least time the card could take (bytes and operations this run's
   data needs, H100 SXM peaks);
2. main_path: ``Localizer(Config(), random_init=True, batch_size=8)``
   predicts 20 batches of seeded random images in one timed call; the K1
   launch count must be exactly 15 per batch; frames/s, ms/batch, the
   feature/solver split; the first-round moments of every level from kernel
   vs plain on the real features; and the trajectory of the card against a
   CPU run of the port at batch 2 (with TF32 convolutions as a known
   perturbation beside it);
3. profile: device time by kernel over one batch's forward
   (torch.profiler; the table goes to chiprun_out/profile_eval_b8.txt),
   the device's busy share (the union of kernel intervals) and idle share,
   convolution and K1 device time.

Every phase prints one JSON line; any failure exits non-zero.  Convolutions
and matrix products run in full fp32 (TF32 off).  The last two lines are
the kernel table and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks: HBM bytes/s and fp32 (non-tensor-core) flop/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# K1 floating-point operations per (sample, channel): bilinear value 9,
# d/dx 5, d/dy 5, eight channel dots 16, and 2 for the target's gg dot,
# which every sample with a nonzero ray mask needs
K1_FLOPS_KEPT = 37
K1_FLOPS_GG = 2
KERNEL_TOL = 1e-4      # |kernel - plain| <= KERNEL_TOL * column scale + 1e-6
ROUND1_TOL = 3e-5      # card vs CPU, round-1 pose (bf16 map; see PERF.md)
BATCH = 8
N_BATCHES = 20         # one timed window of several seconds


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def time_cuda(torch, fn, flush, iters=20, warm=3):
    """Median ms of one call, L2 flushed before each call."""
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def moment_error(got, want):
    """(max abs error, max error over each (row, lane) column's scale)."""
    err = (got - want).abs()
    scale = want.abs().amax(dim=(0, 1), keepdim=True)
    ok = bool((err <= KERNEL_TOL * scale + 1e-6).all())
    rel = float((err / scale.clamp_min(1e-30)).max())
    return float(err.max()), rel, ok


def k1_bound(torch, sat_k, grd, mask, coefs, bf16_map):
    """Least time (ms) for K1's work on these inputs, and what bounds it:
    bytes of every input element the function needs (the map corners the
    kept samples touch, the target rows under a nonzero ray mask, mask, uv
    endpoints) and the output, against the flops of this run's samples."""
    B, A, _, C = sat_k.shape
    V, W = mask.shape
    u = torch.arange(W, device=grd.device, dtype=torch.float32)
    x = coefs[..., 0:1] + coefs[..., 1:2] * u
    y = coefs[..., 2:3] + coefs[..., 3:4] * u
    x0, y0 = torch.floor(x), torch.floor(y)
    keep = ((x >= 0) & (x <= A - 1) & (y >= 0) & (y <= A - 1)
            & (x0 < A - 1) & (y0 < A - 1))
    b = torch.arange(B, device=grd.device)[:, None, None].expand_as(x)[keep]
    xi, yi = x0[keep].long(), y0[keep].long()
    touched = torch.zeros(B, A, A, dtype=torch.bool, device=grd.device)
    for dy in (0, 1):
        for dx in (0, 1):
            touched[b, yi + dy, xi + dx] = True
    live = int((mask != 0).sum()) * B
    n_keep = int(keep.sum())
    elsize = 2 if bf16_map else 4
    nbytes = (int(touched.sum()) * C * elsize + live * C * 4
              + mask.numel() * 4 + 2 * B * V * 2 * 4 + B * V * 48 * 4)
    flops = C * (K1_FLOPS_KEPT * n_keep + K1_FLOPS_GG * live)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def phase_kernels(torch, dev, flush):
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.geometry.kitti import s2gp_uv_jac
    from highlyaccurate_tpu_torch.models.lm_s2gp import precompute_rays
    from highlyaccurate_tpu_torch.ops import banded_warp as bw

    cfg = Config()
    rays = precompute_rays(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for slot, C in zip((0, 1, 2), (256, 128, 64)):
        A = cfg.sat_size >> (3 - slot)
        xyz, mask, _ = rays[slot]
        half = xyz.shape[0] // 2
        xyz01 = torch.from_numpy(np.ascontiguousarray(xyz[half:, :2])).to(dev)
        mask = torch.from_numpy(np.ascontiguousarray(mask[half:])).to(dev)
        V, W = mask.shape
        pose = torch.rand(BATCH, 3, generator=gen, device=dev) * 2 - 1
        uv01, _ = s2gp_uv_jac(pose, xyz01, A, cfg.rotation_range,
                              cfg.shift_range_lat, cfg.shift_range_lon)
        uv01s = uv01.flip(-1)
        uv0, uv1 = uv01s[:, :, 0].contiguous(), uv01s[:, :, 1].contiguous()
        sat = torch.randn(BATCH, A, A, C, generator=gen, device=dev)
        grd = torch.randn(BATCH, V, W, C, generator=gen, device=dev)
        sat = sat / sat.flatten(1).norm(dim=1).view(-1, 1, 1, 1)
        grd = grd / grd.flatten(1).norm(dim=1).view(-1, 1, 1, 1)
        sat_k = sat.to(torch.bfloat16).transpose(1, 2)  # as the model does
        RB = bw.default_rb(A)

        coefs = bw.pack_row_coefs(uv0, uv1, A, RB, W)

        def wrapper():
            return bw.banded_moments(sat_k, grd, mask, uv0, uv1, RB=RB,
                                     bf16_map=True)

        def kernel():  # the launch alone, on packed coefficients
            return bw.moments_from_coefs(sat_k, grd, mask, coefs,
                                         bf16_map=True)

        def plain():
            return bw.moments_from_coefs_reference(sat_k, grd, mask, coefs)

        got = wrapper()
        want = bw.banded_moments_reference(sat_k, grd, mask, uv0, uv1, RB=RB,
                                           bf16_map=True)
        torch.cuda.synchronize()
        abs_err, rel_err, ok = moment_error(got, want)
        bound_ms, bound_by, nbytes, flops = k1_bound(torch, sat_k, grd, mask,
                                                     coefs, True)
        row = dict(phase="kernel_check", kernel="banded_moments", slot=slot,
                   shape=dict(B=BATCH, A=A, C=C, V=V, W=W, RB=RB),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   tol=f"|err| <= {KERNEL_TOL} * column max + 1e-6",
                   within_tol=ok,
                   ms=time_cuda(torch, kernel, flush),
                   plain_ms=time_cuda(torch, plain, flush, iters=5),
                   wrapper_ms=time_cuda(torch, wrapper, flush),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, rows_zeroed_by_guard=int(
                       (coefs[..., 0] == 1e9).sum()))
        emit(row)
        if not ok:
            fail(f"K1 disagrees with its plain version at slot {slot}: "
                 f"max abs {abs_err}, max rel {rel_err}")
        rows.append(row)
    return rows


def phase_main_path(torch, dev):
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.geometry.kitti import s2gp_uv_jac
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP, banded_project
    from highlyaccurate_tpu_torch.ops import banded_warp as bw

    cfg = Config()
    n_levels = cfg.n_levels
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0)
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    n = BATCH * N_BATCHES
    sat = (rng.rand(n, cfg.sat_size, cfg.sat_size, 3) * 255).astype(np.uint8)
    grd = (rng.rand(n, cfg.grd_h, cfg.grd_w, 3) * 255).astype(np.uint8)

    loc.predict(sat[:BATCH], grd[:BATCH])  # warm-up (cuDNN algorithm pick)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bw.banded_moments.launches = 0
    t0 = time.perf_counter()
    out = loc.predict(sat, grd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bw.banded_moments.launches
    per_batch = cfg.N_iters * n_levels
    if launches != per_batch * N_BATCHES:
        fail(f"K1 launched {launches} times for {N_BATCHES} batches, "
             f"expected {per_batch} per batch")
    for k, v in out.items():
        if v.shape != (n,) or not np.isfinite(v).all():
            fail(f"{k}: shape {v.shape} or non-finite values")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # feature / solver split of one batch (device time, CUDA events), with
    # the re-init draw every round as predict makes it
    model, gen = loc.model, loc._generator
    s8 = torch.from_numpy(sat[:BATCH].astype(np.float32) / 255.0).to(dev)
    g8 = torch.from_numpy(grd[:BATCH].astype(np.float32) / 255.0).to(dev)
    flush = torch.empty(1, device=dev)
    with torch.no_grad():
        feat_ms = time_cuda(torch, lambda: model.extract_features(s8, g8),
                            flush, iters=5, warm=1)
        full_ms = time_cuda(
            torch, lambda: model(s8, g8, mode="test", generator=gen),
            flush, iters=5, warm=1)

        # first-round moments of every level, kernel vs plain, real features
        sf, _, gf, _ = model.extract_features(s8, g8)
        pose0 = torch.zeros(BATCH, 3, device=dev)
        m_err = []
        for lvl, slot in enumerate(model._slots):
            A = sf[lvl].shape[1]
            xyz01 = getattr(model, f"xyz01_{slot}")
            mask = getattr(model, f"mask_{slot}")
            uv01, duv01 = s2gp_uv_jac(pose0, xyz01, A, cfg.rotation_range,
                                      cfg.shift_range_lat, cfg.shift_range_lon)
            H = gf[lvl].shape[1]
            rows = gf[lvl][:, H // 2:].contiguous()
            M, _, _ = banded_project(cfg, sf[lvl], uv01, duv01, mask, rows)
            uv01s = uv01.flip(-1)
            Mp = bw.banded_moments_reference(
                sf[lvl].transpose(1, 2), rows, mask, uv01s[:, :, 0],
                uv01s[:, :, 1], RB=bw.default_rb(A), bf16_map=True)
            abs_err, rel_err, ok = moment_error(M, Mp)
            if not ok:
                fail(f"first-round moments disagree at level {lvl}: "
                     f"{abs_err} abs, {rel_err} rel")
            m_err.append(dict(level=lvl, max_abs_err=abs_err,
                              max_rel_err=rel_err))

        # the card against a CPU run of the port, batch 2.  The two
        # generators draw different re-init numbers, so a re-init in round 1
        # would fail the check as loudly as a wrong kernel would.
        cpu = LMS2GP(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t0 = time.perf_counter()
        tc = cpu(s8[:2].cpu(), g8[:2].cpu(), mode="trajectory",
                 generator=torch.Generator().manual_seed(0))
        cpu_s = time.perf_counter() - t0

        def card_traj():
            return model(s8[:2], g8[:2], mode="trajectory",
                         generator=torch.Generator(device=dev).manual_seed(0))
        tg = card_traj()
        # a known perturbation for scale: the same run with TF32 convolutions
        torch.backends.cudnn.allow_tf32 = True
        try:
            tt = card_traj()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    tc, tg, tt = (torch.stack(t, -1).cpu().numpy() for t in (tc, tg, tt))
    if not all(np.isfinite(t).all() for t in (tc, tg, tt)):
        fail("non-finite trajectory")
    d = np.abs(tg - tc)
    round1 = float(d[:, 0, 0].max())
    round1_tf32 = float(np.abs(tt - tc)[:, 0, 0].max())
    if round1 > ROUND1_TOL:
        fail(f"round-1 pose differs between card and CPU by {round1}")

    row = dict(
        phase="main_path", config="KITTI S2GP geo LM, sat 512, grd 256x1024, "
        "level 3, N_iters 5, fp32 features, bf16 map, TF32 off",
        batch=BATCH, batches=N_BATCHES, images=n, wall_s=wall,
        frames_per_s=n / wall, ms_per_batch=wall / N_BATCHES * 1e3,
        k1_launches=launches, k1_launches_per_batch=launches // N_BATCHES,
        features_ms_per_batch=feat_ms, forward_ms_per_batch=full_ms,
        solver_ms_per_batch=full_ms - feat_ms, peak_mem_gb=peak_gb,
        init_s=init_s, first_round_moments=m_err,
        traj_card_vs_cpu=dict(batch=2, round1_max_abs=round1,
                              all_rounds_max_abs=float(d.max()),
                              round1_tol=ROUND1_TOL,
                              round1_max_abs_tf32_convs=round1_tf32,
                              cpu_s=cpu_s),
        lateral_m_first=out["lateral_m"][:4].tolist())
    emit(row)
    return row, model, gen, s8, g8


def phase_profile(torch, model, gen, s8, g8, forward_ms):
    """Device time by kernel over one batch's forward (torch.profiler).
    The profiler slows the host, so the idle share is also given against
    ``forward_ms``, the same forward timed unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        model(s8, g8, mode="test", generator=gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(s8, g8, mode="test", generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_eval_b8.txt", "w") as f:
        f.write(table)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # busy time is the union of the device intervals, so nothing is counted
    # twice; it cannot exceed the wall, and if it does the count is wrong
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3
    if not 0 < busy_ms <= wall_ms:
        fail(f"profile: device busy {busy_ms} ms in a {wall_ms} ms wall")
    k1 = [e for e in kernels if "banded_moments_kernel" in e.name]
    conv_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.key == "aten::cudnn_convolution") / 1e3
    emit(dict(phase="profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
              device_kernel_ms_sum=sum(e.device_time_total
                                       for e in kernels) / 1e3,
              device_idle_share=1 - busy_ms / wall_ms,
              device_idle_share_unprofiled=1 - busy_ms / forward_ms,
              device_kernels=len(kernels), conv_device_ms=conv_ms,
              k1_device_ms=sum(e.device_time_total for e in k1) / 1e3,
              k1_launches=len(k1), table="chiprun_out/profile_eval_b8.txt"))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from highlyaccurate_tpu_torch.ops import _build
        from highlyaccurate_tpu_torch.ops import banded_warp as bw
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the "
             "repository root")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()

    t0 = time.perf_counter()
    libs = _build.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries={k: os.path.relpath(v) for k, v in libs.items()}))

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    shapes = phase_kernels(torch, dev, flush)
    del flush
    main_row, model, gen, s8, g8 = phase_main_path(torch, dev)
    phase_profile(torch, model, gen, s8, g8,
                  main_row["forward_ms_per_batch"])

    emit({"kernels": [dict(
        name="banded_moments", route="cuda",
        source="highlyaccurate_tpu_torch/ops/csrc/banded_moments.cu",
        replaces="highlyaccurate_tpu/ops/pallas/banded_warp.py:704",
        launches=main_row["k1_launches"],
        max_abs_err=max(r["max_abs_err"] for r in shapes),
        ms=sum(r["ms"] for r in shapes),
        plain_ms=sum(r["plain_ms"] for r in shapes),
        bound_ms=sum(r["bound_ms"] for r in shapes),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in shapes)
                  else "operations"),
        library_ms=None)]})
    print(f"gpu: {gpu}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
