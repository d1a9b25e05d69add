#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (highlyaccurate_tpu_torch) on one GPU.

    python3 chip_smoke.py              # from the repository root

Builds the hand-written kernels from the sources in the checkout, then:

1. kernels: K1 (``banded_moments``), K2 (``banded_sample_forward``) and K3
   (``banded_sample_backward``) at each flagship launch shape (KITTI S2GP,
   512x512 satellite, 256x1024 ground, level=3, batch 8, bf16 map), lines
   from ``s2gp_uv_jac`` at random in-range poses, each against its plain
   PyTorch version on the card; kernel and plain times (CUDA events, warmed
   up, L2 flushed before every launch, as the solver finds the map cold)
   beside the least time the card could take (bytes and operations this
   run's data needs, H100 SXM peaks); and the whole VJP of the sampler
   (K2, K3 and the coefficient gradients) against autograd through the
   plain forward at one shape;
2. main_path: ``Localizer(Config(), random_init=True, batch_size=8)``
   predicts 20 batches of seeded random images in one timed call; the K1
   launch count must be exactly 15 per batch, and K2 is never launched;
   frames/s, ms/batch, the feature/solver split; the first-round moments of
   every level from kernel vs plain on the real features; and the
   trajectory of the card against a CPU run of the port at batch 2 (with
   TF32 convolutions as a known perturbation beside it);
3. profile: device time by kernel over one batch's forward
   (torch.profiler; the table goes to chiprun_out/profile_eval_b8.txt),
   the device's busy share (the union of kernel intervals) and idle share,
   convolution and K1 device time;
4. train: ``create_train_state`` and ``make_train_step`` at full width,
   batch 8, on seeded random images and gt poses: one warm-up step, then
   one timed window of ``TRAIN_STEPS`` steps that must launch K2 and K3
   exactly 15 times each per step (and K1 never); steps/s, images/s,
   ms/step, a forward / backward / optimizer split, peak memory, the first
   and last loss; then one step of the card against a CPU run of the port
   at batch 2 on the initial weights and the same data: end to end, the
   solver alone and the networks alone, each beside a known perturbation
   (``card_vs_cpu``);
5. profile_train: device time by kernel over one train step (the table
   goes to chiprun_out/profile_train_b8.txt), busy and idle share,
   convolution, K2 and K3 device time.

Every phase prints one JSON line; any failure exits non-zero.  Convolutions
and matrix products run in full fp32 (TF32 off).  The last three lines are
the kernel table, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.
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
# K2 per kept (sample, channel): value 9, d/dx 5, d/dy 5, dxy 3.  K3: four
# corners of 3 products and 2 sums each, and the 4 adds into the gradient
K2_FLOPS_KEPT = 22
K3_FLOPS_KEPT = 24
KERNEL_TOL = 1e-4      # |kernel - plain| <= KERNEL_TOL * column scale + 1e-6
SAMPLER_TOL = 1e-5     # K2, K3: |kernel - plain| <= SAMPLER_TOL * max + 1e-6
VJP_TOL = 1e-5         # sampler VJP vs autograd: |err| <= VJP_TOL * max
ROUND1_TOL = 3e-5      # card vs CPU, round-1 pose (bf16 map; see PERF.md)
# card vs CPU, one train step at batch 2 (see PERF.md): limits on
# (part, reading); each part is described in card_vs_cpu
TRAIN_TOL = {("end_to_end", "loss_rel_err"): 7e-4,
             ("end_to_end", "grad_rel_l2_all"): 0.05,
             ("solver_only", "loss_rel_err"): 7e-4,
             ("solver_only", "feature_grad_rel_l2_max"): 0.5,
             ("nets_only", "grad_rel_l2_max"): 1e-2,
             ("nets_only", "grad_rel_l2_all"): 5e-3}
BATCH = 8
N_BATCHES = 20         # one timed window of several seconds
TRAIN_STEPS = 10       # the timed train window
TRAIN_CHECK_BATCH = 2  # card vs CPU train step


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


def line_stats(torch, coefs, A, W):
    """(map cells the kept samples' corners touch, kept samples) of these
    lines, with the kernels' sampling rule."""
    B = coefs.shape[0]
    u = torch.arange(W, device=coefs.device, dtype=torch.float32)
    x = coefs[..., 0:1] + coefs[..., 1:2] * u
    y = coefs[..., 2:3] + coefs[..., 3:4] * u
    x0, y0 = torch.floor(x), torch.floor(y)
    keep = ((x >= 0) & (x <= A - 1) & (y >= 0) & (y <= A - 1)
            & (x0 < A - 1) & (y0 < A - 1))
    b = torch.arange(B, device=coefs.device)[:, None, None].expand_as(x)[keep]
    xi, yi = x0[keep].long(), y0[keep].long()
    touched = torch.zeros(B, A, A, dtype=torch.bool, device=coefs.device)
    for dy in (0, 1):
        for dx in (0, 1):
            touched[b, yi + dy, xi + dx] = True
    return int(touched.sum()), int(keep.sum())


def bound(nbytes, flops):
    """(least ms, what bounds it) for bytes over HBM and fp32 flops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(torch, sat_k, grd, mask, coefs, bf16_map):
    """Least time (ms) for K1's work on these inputs, and what bounds it:
    bytes of every input element the function needs (the map corners the
    kept samples touch, the target rows under a nonzero ray mask, mask, uv
    endpoints) and the output, against the flops of this run's samples."""
    B, A, _, C = sat_k.shape
    V, W = mask.shape
    touched, n_keep = line_stats(torch, coefs, A, W)
    live = int((mask != 0).sum()) * B
    elsize = 2 if bf16_map else 4
    nbytes = (touched * C * elsize + live * C * 4
              + mask.numel() * 4 + 2 * B * V * 2 * 4 + B * V * 48 * 4)
    flops = C * (K1_FLOPS_KEPT * n_keep + K1_FLOPS_GG * live)
    return (*bound(nbytes, flops), nbytes, flops)


def max_error(got, want, tol):
    """(max abs error, max error over max|want|, within |err| <= tol *
    max|want| + 1e-6) over a sequence of outputs, each against its own
    max."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / max(scale, 1e-30))
        ok = ok and err <= tol * scale + 1e-6
    return abs_err, rel_err, ok


def sampler_checks(torch, bw, sat_k, coefs, W, gen, flush, slot):
    """K2 and K3 on the map and lines of one flagship shape, each against
    its plain version on the card, timed beside its bound.  Returns the two
    kernel_check rows."""
    B, A, _, C = sat_k.shape
    V = coefs.shape[1]
    touched, n_keep = line_stats(torch, coefs, A, W)
    shape = dict(B=B, A=A, C=C, V=V, W=W)
    out_bytes = B * V * W * C * 4

    got = bw.banded_sample_forward(sat_k, coefs, W, with_dxy=True)
    want = bw.banded_sample_reference(sat_k, coefs, W, with_dxy=True)
    torch.cuda.synchronize()
    abs2, rel2, ok2 = max_error(got, want, SAMPLER_TOL)
    del got, want
    # the map corners the kept samples touch, coefs, four outputs written
    nbytes = (touched * C * sat_k.element_size() + coefs.numel() * 4
              + 4 * out_bytes)
    flops = K2_FLOPS_KEPT * n_keep * C
    k2 = dict(phase="kernel_check", kernel="banded_sample", slot=slot,
              shape=shape, outputs="out, dx, dy, dxy", max_abs_err=abs2,
              max_rel_err=rel2,
              tol=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6 per output",
              within_tol=ok2,
              ms=time_cuda(torch, lambda: bw.banded_sample_forward(
                  sat_k, coefs, W, with_dxy=True), flush),
              plain_ms=time_cuda(torch, lambda: bw.banded_sample_reference(
                  sat_k, coefs, W, with_dxy=True), flush, iters=5),
              bytes=nbytes, flops=flops, kept_samples=n_keep)
    k2["bound_ms"], k2["bound_by"] = bound(nbytes, flops)
    emit(k2)
    if not ok2:
        fail(f"K2 disagrees with its plain version at slot {slot}: "
             f"max abs {abs2}, max rel {rel2}")

    cts = torch.randn(3, B, V, W, C, generator=gen, device=sat_k.device)
    got = bw.banded_sample_backward(coefs, *cts, A)
    want = bw.banded_sample_backward_reference(coefs, *cts, A)
    torch.cuda.synchronize()
    abs3, rel3, ok3 = max_error([got], [want], SAMPLER_TOL)
    del got, want
    # the kept samples' three cotangents, coefs, the gradient written
    nbytes = 3 * n_keep * C * 4 + coefs.numel() * 4 + B * A * A * C * 4
    flops = K3_FLOPS_KEPT * n_keep * C
    k3 = dict(phase="kernel_check", kernel="banded_sample_backward",
              slot=slot, shape=shape, max_abs_err=abs3, max_rel_err=rel3,
              tol=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6 (fp32 "
              "atomics: each map cell's sum in a run-dependent order)",
              within_tol=ok3,
              ms=time_cuda(torch, lambda: bw.banded_sample_backward(
                  coefs, *cts, A), flush),
              plain_ms=time_cuda(
                  torch, lambda: bw.banded_sample_backward_reference(
                      coefs, *cts, A), flush, iters=5),
              bytes=nbytes, flops=flops, kept_samples=n_keep)
    k3["bound_ms"], k3["bound_by"] = bound(nbytes, flops)
    emit(k3)
    if not ok3:
        fail(f"K3 disagrees with its plain version at slot {slot}: "
             f"max abs {abs3}, max rel {rel3}")
    return k2, k3


def sampler_vjp_check(torch, bw, sat, uv0, uv1, W, RB, gen):
    """The sampler's whole VJP (K2 with dxy, K3 and the coefficient
    gradients) against autograd through the plain forward, fp32 map (a bf16
    cast outside the function would round the plain map gradient)."""
    sat = sat.detach().requires_grad_()
    uvs = [t.detach().requires_grad_() for t in (uv0, uv1)]
    sat_t = sat.transpose(1, 2)
    cts = torch.randn(3, *sat.shape[:1], uv0.shape[1], W, sat.shape[3],
                      generator=gen, device=sat.device)

    def grads(outs):
        loss = sum((o * c).sum() for o, c in zip(outs, cts))
        return torch.autograd.grad(loss, [sat, *uvs])

    got = grads(bw.banded_sample(sat_t, *uvs, W=W, RB=RB, bf16_map=False))
    coefs = bw.pack_row_coefs(*uvs, sat.shape[1], RB, W)
    want = grads(bw.banded_sample_reference(sat_t, coefs, W, with_dxy=False))
    errs = {}
    for name, g, w in zip(("sat", "uv0", "uv1"), got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        errs[name] = dict(max_abs_err=err, max_rel_err=err / max(scale, 1e-30))
        if err > VJP_TOL * scale:
            fail(f"sampler VJP: d/d{name} differs from autograd by {err} "
                 f"(max {scale})")
    return errs


def phase_kernels(torch, dev, flush):
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.geometry.kitti import s2gp_uv_jac
    from highlyaccurate_tpu_torch.models.lm_s2gp import precompute_rays
    from highlyaccurate_tpu_torch.ops import banded_warp as bw

    cfg = Config()
    rays = precompute_rays(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    gen_s = torch.Generator(device=dev).manual_seed(2)  # K2/K3 map, cotangents
    rows = {"banded_moments": [], "banded_sample": [],
            "banded_sample_backward": []}
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
        rows["banded_moments"].append(row)

        # K2 and K3 on the same lines, an O(1) bf16 map as training gives it
        sat_s = torch.randn(BATCH, A, A, C, generator=gen_s, device=dev)
        k2, k3 = sampler_checks(torch, bw, sat_s.to(torch.bfloat16).transpose(
            1, 2), coefs, W, gen_s, flush, slot)
        rows["banded_sample"].append(k2)
        rows["banded_sample_backward"].append(k3)
        if slot == 1:
            emit(dict(phase="sampler_vjp", slot=slot, shape=k2["shape"],
                      map="float32", tol=f"|err| <= {VJP_TOL} * max",
                      grads=sampler_vjp_check(torch, bw, sat_s, uv0, uv1, W,
                                              RB, gen_s)))
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
    bw.banded_sample.launches = 0
    t0 = time.perf_counter()
    out = loc.predict(sat, grd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bw.banded_moments.launches
    per_batch = cfg.N_iters * n_levels
    if launches != per_batch * N_BATCHES:
        fail(f"K1 launched {launches} times for {N_BATCHES} batches, "
             f"expected {per_batch} per batch")
    if bw.banded_sample.launches:
        fail(f"serving launched K2 {bw.banded_sample.launches} times")
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


def profiled(torch, fn, table_path):
    """Run ``fn`` once under torch.profiler after one unprofiled run.
    Returns (wall ms, device busy ms as the union of kernel intervals, the
    device kernel events, the profiler); writes the table by kernel time to
    ``table_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    with open(table_path, "w") as f:
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
    return wall_ms, busy_ms, kernels, prof


def device_ms(events, name):
    """(device ms, count) of the kernel events whose name holds ``name``."""
    hits = [e for e in events if name in e.name]
    return sum(e.device_time_total for e in hits) / 1e3, len(hits)


def conv_device_ms(prof, keys):
    return sum(e.device_time_total for e in prof.key_averages()
               if e.key in keys) / 1e3


def phase_profile(torch, model, gen, s8, g8, forward_ms):
    """Device time by kernel over one batch's forward (torch.profiler).
    The profiler slows the host, so the idle share is also given against
    ``forward_ms``, the same forward timed unprofiled."""
    table = "chiprun_out/profile_eval_b8.txt"
    with torch.no_grad():
        wall_ms, busy_ms, kernels, prof = profiled(
            torch, lambda: model(s8, g8, mode="test", generator=gen), table)
    k1_ms, k1_n = device_ms(kernels, "banded_moments_kernel")
    emit(dict(phase="profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
              device_kernel_ms_sum=sum(e.device_time_total
                                       for e in kernels) / 1e3,
              device_idle_share=1 - busy_ms / wall_ms,
              device_idle_share_unprofiled=1 - busy_ms / forward_ms,
              device_kernels=len(kernels),
              conv_device_ms=conv_device_ms(prof, ("aten::cudnn_convolution",)),
              k1_device_ms=k1_ms, k1_launches=k1_n, table=table))


def rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def train_grads(torch, model, sat, grd, gt, generator):
    """Loss and every parameter's gradient (None: no gradient) of one
    training forward and backward, without an optimizer step."""
    model.zero_grad(set_to_none=True)
    out = model(sat, grd, mode="train", gt_pose=gt, generator=generator)
    out.loss.backward()
    return float(out.loss.detach()), {k: None if p.grad is None
                             else p.grad.detach().float().cpu()
                             for k, p in model.named_parameters()}


def feature_maps(model, sat, grd):
    """The two networks' feature pyramids, satellite levels then ground."""
    sf, _, gf, _ = model.extract_features(sat, grd)
    return [*sf, *gf]


def solver_grads(torch, model, feats, sat, grd, gt, generator):
    """The loss of the solver rounds on the given feature maps (the
    networks bypassed) and its gradient with respect to each map."""
    leaves = [f.detach().requires_grad_() for f in feats]
    n = len(leaves) // 2
    model.extract_features = lambda s, g: (leaves[:n], None, leaves[n:], None)
    try:
        loss = model(sat, grd, mode="train", gt_pose=gt,
                     generator=generator).loss
    finally:
        del model.extract_features
    return (float(loss.detach()),
            [g.cpu() for g in torch.autograd.grad(loss, leaves)])


def net_grads(torch, model, sat, grd, cts):
    """Every parameter's gradient of sum(feature map * cotangent) through
    the two networks (None: no gradient)."""
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(
        feature_maps(model, sat, grd), params,
        grad_outputs=[c.to(sat.device) for c in cts], allow_unused=True)
    return {k: None if g is None else g.cpu() for k, g in zip(names, grads)}


def grad_errors(torch, grads, ref):
    """relL2 of each gradient against ``ref`` (over the names ``ref``
    holds): the largest, the median, and over all of them at once."""
    if any(grads.get(k) is None for k in ref):
        fail("a parameter got a gradient on the CPU but none on the card")
    rel = {k: rel_l2(grads[k], g) for k, g in ref.items()}
    worst = max(rel, key=rel.get)
    return dict(grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
                grad_rel_l2_median=float(np.median(list(rel.values()))),
                grad_rel_l2_all=rel_l2(
                    torch.cat([grads[k].flatten() for k in ref]),
                    torch.cat([g.flatten() for g in ref.values()])))


def card_vs_cpu(torch, cfg, weights, args, dev):
    """One train step of the card against a CPU run of the port, on the
    same weights and data, each part beside a known perturbation for
    scale:
    * end to end: the loss and every parameter's gradient (and with TF32
      convolutions);
    * the solver alone on the CPU's feature maps: the loss and the feature
      gradients (and the card with K2 / K3's plain versions in place of
      the kernels, which differ from them in the last bits only);
    * the networks alone under the CPU's feature gradients: every
      parameter's gradient (and with TF32 convolutions)."""
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    cpu = LMS2GP(cfg, device="cpu")
    cpu.load_state_dict(weights)
    card = LMS2GP(cfg, device=dev)
    card.load_state_dict(weights)
    sat, grd, gt = args
    cargs = [t.cpu() for t in args]
    t0 = time.perf_counter()
    feats_c = feature_maps(cpu, *cargs[:2])
    loss_c, fg_c = solver_grads(torch, cpu, feats_c, *cargs,
                                torch.Generator().manual_seed(0))
    pg_c = {k: g for k, g in net_grads(torch, cpu, *cargs[:2], fg_c).items()
            if g is not None}
    cpu_s = time.perf_counter() - t0

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def end_to_end():
        loss, grads = train_grads(torch, card, sat, grd, gt, gen())
        return dict(loss_rel_err=abs(loss - loss_c) / abs(loss_c),
                    **grad_errors(torch, grads, pg_c))

    def tf32(fn):
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = False

    def nets_only():
        return grad_errors(torch, net_grads(torch, card, sat, grd, fg_c), pg_c)

    def solver_only(ref_loss, ref_grads):
        loss, grads = solver_grads(torch, card, [f.to(dev) for f in feats_c],
                                   sat, grd, gt, gen())
        return loss, grads, dict(
            loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
            feature_grad_rel_l2_max=max(
                rel_l2(g, r) for g, r in zip(grads, ref_grads)))

    row = dict(cpu_loss=loss_c, params_compared=len(pg_c), cpu_s=cpu_s,
               end_to_end=end_to_end(), end_to_end_tf32=tf32(end_to_end),
               nets_only=nets_only(), nets_only_tf32=tf32(nets_only))
    loss_s, fg_g, row["solver_only"] = solver_only(loss_c, fg_c)
    kernels = bw.banded_sample_forward, bw.banded_sample_backward
    bw.banded_sample_forward = (lambda sat_k, coefs, W, *, with_dxy:
                                bw.banded_sample_reference(sat_k, coefs, W,
                                                           with_dxy))
    bw.banded_sample_backward = bw.banded_sample_backward_reference
    try:
        row["solver_only_kernels_vs_plain"] = solver_only(loss_s, fg_g)[2]
    finally:
        bw.banded_sample_forward, bw.banded_sample_backward = kernels
    return row


def phase_train(torch, dev):
    """The flagship training step at full width, batch 8: a timed window
    through ``make_train_step``, its split, and the card against the CPU."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    from highlyaccurate_tpu_torch.params import init_params
    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step

    cfg = Config()
    t0 = time.perf_counter()
    model = LMS2GP(cfg, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg)
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(1)
    n = TRAIN_STEPS + 1
    sat = torch.from_numpy((rng.rand(n, BATCH, cfg.sat_size, cfg.sat_size, 3)
                            * 255).astype(np.uint8)).to(dev).float() / 255.0
    grd = torch.from_numpy((rng.rand(n, BATCH, cfg.grd_h, cfg.grd_w, 3)
                            * 255).astype(np.uint8)).to(dev).float() / 255.0
    gt = torch.from_numpy(rng.uniform(-1, 1, (n, BATCH, 3)).astype(
        np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    state, m = step(state, sat[0], grd[0], gt[0], gen)  # warm-up
    torch.cuda.synchronize()
    first_loss = float(m["loss"])
    torch.cuda.reset_peak_memory_stats()
    bw.banded_moments.launches = 0
    bw.banded_sample.launches = 0
    bw.banded_sample_backward.launches = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(1, n):
        state, m = step(state, sat[i], grd[i], gt[i], gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2_n, k3_n = bw.banded_sample.launches, bw.banded_sample_backward.launches
    per_step = cfg.N_iters * cfg.n_levels
    if (k2_n, k3_n) != (per_step * TRAIN_STEPS,) * 2:
        fail(f"K2 / K3 launched {k2_n} / {k3_n} times in {TRAIN_STEPS} "
             f"steps, expected {per_step} each per step")
    if bw.banded_moments.launches:
        fail(f"training launched K1 {bw.banded_moments.launches} times")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first_loss] + [float(v) for v in losses]
    if not np.isfinite(losses).all():
        fail(f"non-finite train loss: {losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail("non-finite parameters after training")

    # forward / backward / optimizer split of one step (CUDA events; each
    # span also holds the time the device waits on the host)
    opt = state.optimizer
    spans = []
    for i in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        out = model(sat[i], grd[i], mode="train", gt_pose=gt[i],
                    generator=gen)
        ev[1].record()
        out.loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        spans.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    fwd_ms, bwd_ms, opt_ms = np.median(np.array(spans), axis=0).tolist()
    step_ms = wall / TRAIN_STEPS * 1e3
    emit(dict(
        phase="train", config="KITTI S2GP geo LM, sat 512, grd 256x1024, "
        "level 3, N_iters 5, fp32 features, bf16 map, TF32 off, Adam",
        batch=BATCH, steps=TRAIN_STEPS, wall_s=wall,
        steps_per_s=TRAIN_STEPS / wall, images_per_s=TRAIN_STEPS * BATCH / wall,
        ms_per_step=step_ms, k2_launches=k2_n, k3_launches=k3_n,
        k2_launches_per_step=k2_n // TRAIN_STEPS,
        k3_launches_per_step=k3_n // TRAIN_STEPS,
        forward_ms=fwd_ms, backward_ms=bwd_ms, optimizer_ms=opt_ms,
        peak_mem_gb=peak_gb, init_s=init_s, first_loss=losses[0],
        last_loss=losses[-1], losses=losses))

    # the card against a CPU run of the port at batch 2, on the initial
    # weights and the first batch's data
    b = TRAIN_CHECK_BATCH
    row = card_vs_cpu(torch, cfg, weights, (sat[0, :b], grd[0, :b],
                                            gt[0, :b]), dev)
    emit(dict(phase="train_card_vs_cpu", batch=b, **row, limits={
        f"{part}.{key}": tol for (part, key), tol in TRAIN_TOL.items()}))
    failed = [f"{part} {key} {row[part][key]} > {tol}"
              for (part, key), tol in TRAIN_TOL.items()
              if not row[part][key] <= tol]
    if failed:
        fail("train step, card vs CPU: " + "; ".join(failed))
    return dict(k2_launches=k2_n, k3_launches=k3_n, ms_per_step=step_ms,
                per_step=per_step,
                model=model, state=state, step=step,
                batch=(sat[0], grd[0], gt[0]), gen=gen)


def phase_profile_train(torch, train):
    """Device time by kernel over one train step (torch.profiler), beside
    the unprofiled ms/step of the timed window."""
    table = "chiprun_out/profile_train_b8.txt"
    state = train["state"]

    def one_step():
        nonlocal state
        state, _ = train["step"](state, *train["batch"], train["gen"])

    wall_ms, busy_ms, kernels, prof = profiled(torch, one_step, table)
    k2_ms, k2_n = device_ms(kernels, "banded_sample_kernel")
    k3_ms, k3_n = device_ms(kernels, "banded_sample_backward_kernel")
    emit(dict(phase="profile_train", wall_ms=wall_ms, device_busy_ms=busy_ms,
              device_kernel_ms_sum=sum(e.device_time_total
                                       for e in kernels) / 1e3,
              device_idle_share=1 - busy_ms / wall_ms,
              device_idle_share_unprofiled=1 - busy_ms / train["ms_per_step"],
              device_kernels=len(kernels),
              conv_device_ms=conv_device_ms(
                  prof, ("aten::cudnn_convolution",
                         "aten::convolution_backward")),
              k2_device_ms=k2_ms, k2_launches=k2_n, k3_device_ms=k3_ms,
              k3_launches=k3_n, table=table))
    if (k2_n, k3_n) != (train["per_step"],) * 2:
        fail(f"profiled step shows {k2_n} K2 and {k3_n} K3 kernels")


def kernel_entry(name, source, replaces, launches, rows):
    """One kernel's entry of the kernels line, summed over its shapes."""
    return dict(
        name=name, route="cuda",
        source=f"highlyaccurate_tpu_torch/ops/csrc/{source}",
        replaces=f"highlyaccurate_tpu/ops/pallas/banded_warp.py:{replaces}",
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                  else "operations"),
        library_ms=None)


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
    del model, gen, s8, g8
    torch.cuda.empty_cache()
    train = phase_train(torch, dev)
    phase_profile_train(torch, train)

    # library_ms is null for all three: no single PyTorch call computes
    # them (grid_sample gives neither the derivatives nor the edge quirk)
    emit({"kernels": [
        kernel_entry("banded_moments", "banded_moments.cu", 704,
                     main_row["k1_launches"], shapes["banded_moments"]),
        kernel_entry("banded_sample", "banded_sampler.cu", 1046,
                     train["k2_launches"], shapes["banded_sample"]),
        kernel_entry("banded_sample_backward", "banded_sampler.cu", 1147,
                     train["k3_launches"], shapes["banded_sample_backward"]),
    ]})
    print(f"gpu: {gpu}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
