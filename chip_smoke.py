#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (highlyaccurate_tpu_torch) on one GPU.

    python3 chip_smoke.py              # from the repository root

Builds the hand-written kernels from the sources in the checkout, then:

1. kernels: K1 (``banded_moments``), K2 (``banded_sample_forward``) and K3
   (``banded_sample_backward``) at each flagship launch shape (KITTI S2GP,
   512x512 satellite, 256x1024 ground, level=3, batch 8, bf16 map), lines
   from ``s2gp_uv_jac`` at random in-range poses; and K4
   (``projline_sample_forward``), K5 (``projline_sample_backward``) and K6
   (``projline_pixmom``) at each flagship G2SP level, lines from
   ``g2sp_P`` with the default K.
   Each against its plain PyTorch version on the card (K1, K3, K5 and K6
   also launched a second time: ``repeatable`` when the bits agree; K5's
   row also says how its samples spread over its tiles); kernel and
   plain times (CUDA events, warmed up, L2 flushed before every launch, as the
   solver finds the map cold) beside the least time the card could take
   (bytes and operations this run's data needs, H100 SXM peaks); and the
   whole VJP of each sampler (K2/K3, K4/K5 and their coefficient
   gradients) against autograd through the plain forward at one shape;
   kernel_edge_lines: K1, K2 and K3 against their plain versions on
   hand-made lines (``edge_line_coefs``) at A = 64, each flagship C and W
   in {24, 130, 512}; kernel_edge_projlines: K4, K5 and K6 on hand-made
   projective lines (``EDGE_PROJLINES``) on a 32 x 128 map, each flagship
   C and W in {24, 130, 256}, K5 and K6 twice, bit for bit;
2. main_path: ``Localizer(Config(), random_init=True, batch_size=8)``
   predicts 20 batches of seeded random images in one timed call; K1 must
   launch exactly 15 times per batch and no other kernel; frames/s,
   ms/batch, the feature/solver split; the first-round moments of every
   level from kernel vs plain on the real features; and the trajectory of
   the card against a CPU run of the port at batch 2 (with TF32
   convolutions as a known perturbation beside it);
3. profile: device time by kernel over one batch's forward
   (torch.profiler; the table goes to chiprun_out/profile_eval_b8.txt),
   the device's busy share (the union of kernel intervals) and idle share,
   convolution and K1 device time;
4. train: ``create_train_state`` and ``make_train_step`` at full width,
   batch 8, on seeded random images and gt poses: one warm-up step, then
   one timed window of ``TRAIN_STEPS`` steps that must launch K2 and K3
   exactly 15 times each per step (and no other kernel); steps/s,
   images/s, ms/step, a forward / backward / optimizer split, peak memory,
   the first and last loss; then one step of the card against a CPU run
   of the port at batch 2 on the initial weights and the same data: end to
   end, the solver alone and the networks alone, each beside a known
   perturbation (``card_vs_cpu``);
5. profile_train: device time by kernel over one train step (the table
   goes to chiprun_out/profile_train_b8.txt), busy and idle share,
   convolution, K2 and K3 device time;
6. g2sp_main_path, profile_g2sp, g2sp_train, profile_g2sp_train: the same
   for KITTI G2SP (``Config(direction="G2SP")``, the default K): serving
   ``G2SP_BATCHES`` batches with exactly 15 K4 launches per batch, and
   ``G2SP_TRAIN_STEPS`` train steps with exactly 15 K4 and 15 K5 launches
   per step, each against a CPU run of the port at batch 2 (tables in
   chiprun_out/profile_g2sp_eval_b8.txt and profile_g2sp_train_b8.txt);
7. g2sp_pixmom_main_path, profile_g2sp_pixmom: G2SP serving with the fused
   pixel moments (``g2sp_pixel_moments=1``) on the same weights and images:
   exactly 15 K6 (``projline_pixmom``) launches per batch and no K4; the
   poses against the K4 path on the same card and against a CPU run
   (table in chiprun_out/profile_g2sp_pixmom_eval_b8.txt).  K6 is also
   checked in phase 1, at each G2SP level, against its plain version and
   against K4's samples contracted in torch;
8. ford_main_path, profile_ford, ford_train, profile_ford_train: Ford
   LM_S2GP_Ford (``Config()``, the Ford rig, a 512 x 0.22 m patch):
   serving ``FORD_BATCHES`` batches with exactly 15 K1 launches per batch
   (the kernel layout the rig takes and the samples it keeps in round 1,
   beside the JAX package's layout), and ``FORD_TRAIN_STEPS`` train steps
   with exactly 15 K2 and 15 K3 launches per step, each against a CPU run
   of the port at batch 2 (tables in chiprun_out/profile_ford_eval_b8.txt
   and profile_ford_train_b8.txt).

9. cli_kitti: the KITTI CLI (``cli/train_kitti.main``, in this
   process) at the flagship defaults, S2GP (16 synthetic samples) and G2SP
   (8), batch 8, cuDNN's deterministic algorithms (so a run repeats bit
   for bit): 2 epochs of training, each train step checked to launch
   exactly 15 K2 and 15 K3 (G2SP: 15 K4 and 15 K5) and each evaluation
   batch 15 K1 (G2SP: 15 K4); then ``--test 1`` on copies of the
   experiment directory: float32 (its predictions equal epoch 1's
   in-training evaluation bit for bit), bf16 features (the default;
   within ``CLI_BF16_LIMIT`` of float32) and epoch 0's weights (for
   scale).  Files under build/cli_smoke/, the CLI's printing in
   chiprun_out/cli_kitti.log; images/s of the train steps without step 0
   and each evaluation's ``time_per_image``;
10. gather_main_path: the gather sampler path (``use_banded_warp=0``) of
   S2GP, G2SP and Ford serving at the flagship widths on the weights and
   images of the banded phases: ``GATHER_BATCHES`` batches of
   ``Localizer.predict`` that launch no hand kernel (frames/s, ms/batch,
   a profile of one forward in chiprun_out/profile_gather_<family>
   _eval_b8.txt), the card against a CPU run at batch 2
   (``GATHER_ROUND1_TOL``), the poses against the banded path's (printed,
   not gated); one S2GP train step through the gather path against a CPU
   run at batch 2 (``GATHER_TRAIN_TOL``); and G2SP at a 32-row ground
   input, whose coarse level takes the gather sampler and the others K4
   (exactly 10 K4 launches per batch), against a CPU run;
11. cli_ford: the Ford CLI (``cli/train_ford.main``) at the flagship
   defaults as cli_kitti drives the KITTI one (16 synthetic samples with
   the Ford data's rig, 2 epochs, each train step 15 K2 and 15 K3, each
   evaluation batch 15 K1; ``--test 1`` reloads of ``Model_best`` at
   float32, bit for bit, and bf16, within ``CLI_BF16_LIMIT``), then one
   ``--transformer 1`` epoch from a ``Model_best`` in the base experiment,
   whose feature networks must stay bit-equal (chiprun_out/cli_ford.log).

12. serving_api: the rest of the serving API at the flagship widths
   (``phase_serving_api``): the host microseconds of a K1 launch through
   its custom op against the bare ctypes launch;
   ``predict(return_cov=True)`` of S2GP, G2SP and Ford at batch 8 (15
   launches of the solver kernel per batch; the covariance finite,
   symmetric, positive definite on the active DoFs; the covariance at
   one pose against the CPU twin at batch 2); the
   multi-start sweep of S2GP and G2SP with 4 hypotheses at batch 2 (the
   same draws on the card and the CPU twin: the same winner, the pose
   within ``SERVING_MULTI_TOL``; a window whose solver kernel launches at
   batch 8, frames/s); ``calibrate`` on two synthetic batches; and
   ``export`` of S2GP (batch size 1) and G2SP (batch size 8), one program
   each (``SERVING_EXPORT_SIZES``), served by ``ExportedLocalizer`` in a
   fresh process (its launches, its outputs bit for bit against a live
   Localizer of its batch size, its latency for one image; artifacts under
   build/serving_api/), and, while the exports trace, the same 9 images
   at batch 1 and at batch 8 on the live model with the same re-init
   numbers (round 1 and the final pose within ``SERVING_CROSS_TOL``;
   S2GP also on the CPU twin).
13. solver_options: the solver options at the flagship widths and depth
   (``phase_solver_options``, ``SOLVER_OPTIONS``): S2GP with
   ``level_first`` (15 K1 per serving batch), ``dropout`` (15 K2, no K1),
   ``Optimizer`` ADAM and NN (15 K2), ``using_weight`` (the gather
   sampler, no hand kernel) and ``loss_method=3`` (training only, no hand
   kernel), Ford with ``Optimizer=GN`` (15 K2) and G2SP with
   ``using_weight`` (no hand kernel): a serving window of
   ``SOLVER_BATCHES`` batches and a train window of
   ``SOLVER_TRAIN_STEPS`` steps (15 K2 and 15 K3 per step where the table
   says so) with exact launch counts, frames/s, ms/step and peak memory;
   each against a CPU run of the port at batch 2 on the same draws (drawn
   on the CPU: a CUDA generator gives another stream), beside the card
   with TF32 convolutions: the round-1 pose within ``SOLVER_ROUND1_TOL``,
   the train step's loss and gradients within ``SOLVER_TRAIN_TOL`` (loss
   method 3's gradients are NaN, in the same tensors, as in JAX).
14. proj_options: the projection and depth options at the flagship widths
   and depth (``phase_proj_options``, ``PROJ_OPTIONS``): S2GP with
   ``proj="polar"`` and ``use_gt_depth`` (also the model's forward with a
   seeded [8, 256, 1024] ``gt_depth``, ~10% of it -1), G2SP with
   ``proj`` nn and polar, Ford with ``proj="polar"`` and
   ``estimate_depth`` (the depth heads' last conv drawn non-zero): each a
   serving window and a train window, as phase 13, in which no K1-K6 may
   launch (each option leaves the banded path, as in JAX), each against a
   CPU run at batch 2 within ``PROJ_ROUND1_TOL`` / ``PROJ_TRAIN_TOL``;
   then one CLI epoch of G2SP ``--proj nn`` and of Ford ``--estimate_depth
   1``, each reloaded with ``--test 1`` at float32, bit for bit.

``python3 chip_smoke.py --ab-g2sp-kernels DIR`` instead times K4-K6 of a
second checkout in DIR (the parent commit) and of this one in turns, and
``--ab-e2e DIR`` the S2GP serving and training cells (``ab_turns``);
``--serving-api`` runs the kernels' build and phase 12 alone,
``--solver-options [NAME ...]`` phase 13 (or the configurations named, as
in ``SOLVER_OPTIONS``), ``--proj-options [NAME ...]`` phase 14 (names as
in ``PROJ_OPTIONS``).

Every phase prints one JSON line; any failure exits non-zero.  Convolutions
and matrix products run in full fp32 (TF32 off).  The last four lines are
the seconds the run took, the kernel table, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

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
# K6 per kept (sample, channel): value 9, d/dx 5, d/dy 5, the residual 1
# and five products summed (10)
K6_FLOPS_KEPT = 30
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
# G2SP, card vs CPU (see PERF.md section 6): the round-1 pose of
# serving, and one train step at batch 2 in the three parts of TRAIN_TOL;
# each limit sits between the reading and a known perturbation
G2SP_ROUND1_TOL = 1e-5
G2SP_TRAIN_TOL = {("end_to_end", "loss_rel_err"): 1e-5,
                  ("end_to_end", "grad_rel_l2_all"): 1e-2,
                  ("solver_only", "loss_rel_err"): 1e-5,
                  ("solver_only", "feature_grad_rel_l2_max"): 0.1,
                  ("nets_only", "grad_rel_l2_max"): 1e-2,
                  ("nets_only", "grad_rel_l2_all"): 5e-3}
# G2SP serving with K6 against the K4 path on the same card, the same
# samples with the channel sums in another order: limits on the (round-1,
# final) pose (see PERF.md section 6)
PIXMOM_VS_K4_TOL = (1e-6, 1e-4)
# Ford, card vs CPU (see PERF.md section 6): the round-1 pose of serving,
# and one train step at batch 2 in the three parts of TRAIN_TOL; each limit
# sits between the reading and a known perturbation, save the solver's
# feature gradients, which the kernels against their plain versions move
# as far as the CPU does (as in S2GP)
FORD_ROUND1_TOL = 1e-4
FORD_TRAIN_TOL = {("end_to_end", "loss_rel_err"): 2e-4,
                  ("end_to_end", "grad_rel_l2_all"): 0.03,
                  ("solver_only", "loss_rel_err"): 2e-4,
                  ("solver_only", "feature_grad_rel_l2_max"): 0.2,
                  ("nets_only", "grad_rel_l2_max"): 1e-2,
                  ("nets_only", "grad_rel_l2_all"): 5e-3}
# the Ford data's front-left camera -> body calibration (quaternion w, x,
# y, z and translation in meters) and its 512-pixel patch at 0.22 m/pixel
FORD_QVEC = (0.496157034, -0.486630591, 0.507791308, -0.509084328)
FORD_T_FL = (1.470563, 0.405664, 1.243369)
FORD_SIDE_M = 512 * 0.22
BATCH = 8
N_BATCHES = 20         # one timed window of several seconds
TRAIN_STEPS = 10       # the timed train window
TRAIN_CHECK_BATCH = 2  # card vs CPU train step
G2SP_BATCHES = 10      # the G2SP serving windows (K4, K6)
G2SP_TRAIN_STEPS = 5   # the G2SP train window
FORD_BATCHES = 10      # the Ford serving window
FORD_TRAIN_STEPS = 5   # the Ford train window


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


def ptxas_lines(log):
    """Each kernel's registers, shared memory and spills from nvcc's -v
    output (the log of a build in this run)."""
    if not log.exists():
        return None
    keep = ("Compiling entry", "registers", "spill")
    return [ln.split(":", 1)[-1].strip() for ln in log.read_text().splitlines()
            if any(k in ln for k in keep)]


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


def cell_stats(torch, cells, AY, AX):
    """Of the bilinear cells (x0, y0, fx, fy, m) of a kernel's samples, with
    its sampling rule: (map cells the kept samples' corners touch, kept
    samples, the most kept samples whose corner (y0, x0) is one map cell,
    and the mean over the cells that hold any).  The last two say how many
    atomic adds of the backward kernels meet on one address."""
    x0, y0, _, _, m = cells
    keep = m > 0
    B = x0.shape[0]
    b = torch.arange(B, device=x0.device)[:, None, None].expand_as(x0)[keep]
    xi, yi = x0[keep], y0[keep]
    touched = torch.zeros(B, AY, AX, dtype=torch.bool, device=x0.device)
    for dy in (0, 1):
        for dx in (0, 1):
            touched[b, yi + dy, xi + dx] = True
    hits = torch.bincount((b * AY + yi) * AX + xi, minlength=B * AY * AX)
    held = hits[hits > 0]
    return (int(touched.sum()), int(keep.sum()), int(hits.max()),
            float(held.float().mean()) if held.numel() else 0.0)


def tile_stats(torch, cells, AY, AX):
    """Of the bilinear cells (x0, y0, fx, fy, m) of the projective lines'
    samples, over K5's tiles of 8 map columns x 4 map rows of each image:
    (tiles, tiles that some kept sample's corners touch, the most kept
    samples touching one tile).  The last is the longest list one K5
    block walks."""
    x0, y0, _, _, m = cells
    keep = m > 0
    B = x0.shape[0]
    nt, nty = -(-AX // 8), -(-AY // 4)
    b = torch.arange(B, device=x0.device)[:, None, None].expand_as(x0)[keep]
    xi, yi = x0[keep], y0[keep]
    n = xi.numel()
    if n == 0:
        return B * nt * nty, 0, 0
    keys = torch.stack([(b * nty + (yi + dy) // 4) * nt + (xi + dx) // 8
                        for dy in (0, 1) for dx in (0, 1)])
    sid = torch.arange(n, device=x0.device)
    tiles = torch.unique(keys * n + sid) // n  # each sample once per tile
    hits = torch.bincount(tiles, minlength=B * nt * nty)
    return B * nt * nty, int((hits > 0).sum()), int(hits.max())


def bound(nbytes, flops):
    """(least ms, what bounds it) for bytes over HBM and fp32 flops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(torch, bw, sat_k, grd, mask, coefs, bf16_map):
    """Least time (ms) for K1's work on these inputs, and what bounds it:
    bytes of every input element the function needs (the map corners the
    kept samples touch, the target rows under a nonzero ray mask, mask, uv
    endpoints) and the output, against the flops of this run's samples."""
    B, A, _, C = sat_k.shape
    V, W = mask.shape
    touched, n_keep, _, _ = cell_stats(torch, bw._line_cells(coefs, W, A),
                                       A, A)
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


def repeatable(torch, got, launch):
    """Whether a second launch on the same inputs gives ``got`` bit for
    bit (synchronises first)."""
    again = launch()
    torch.cuda.synchronize()
    return bool(torch.equal(got, again))


def _counters():
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    from highlyaccurate_tpu_torch.ops import projline as tpl
    return {"k1": bw.banded_moments, "k2": bw.banded_sample,
            "k3": bw.banded_sample_backward,
            "k4": tpl.projline_sample_forward,
            "k5": tpl.projline_sample_backward, "k6": tpl.projline_pixmom}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in _counters().values():
        fn.launches = 0


def expect_launches(what, expected):
    """Every kernel's launch count since ``reset_launches``; fails unless
    the kernels in ``expected`` launched exactly that often and the others
    never."""
    got = {k: fn.launches for k, fn in _counters().items()}
    want = {k: expected.get(k, 0) for k in got}
    if got != want:
        fail(f"{what} launched the kernels {got} times, expected {want}")
    return got


def sampler_checks(torch, bw, sat_k, coefs, W, gen, flush, slot):
    """K2 and K3 on the map and lines of one flagship shape, each against
    its plain version on the card, timed beside its bound.  Returns the two
    kernel_check rows."""
    B, A, _, C = sat_k.shape
    V = coefs.shape[1]
    touched, n_keep, max_hits, mean_hits = cell_stats(
        torch, bw._line_cells(coefs, W, A), A, A)
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
    rep3 = repeatable(torch, got, lambda: bw.banded_sample_backward(
        coefs, *cts, A))
    abs3, rel3, ok3 = max_error([got], [want], SAMPLER_TOL)
    del got, want
    # the kept samples' three cotangents, coefs, the gradient written
    nbytes = 3 * n_keep * C * 4 + coefs.numel() * 4 + B * A * A * C * 4
    flops = K3_FLOPS_KEPT * n_keep * C
    k3 = dict(phase="kernel_check", kernel="banded_sample_backward",
              slot=slot, shape=shape, max_abs_err=abs3, max_rel_err=rel3,
              tol=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6 (each map "
              "cell's sum in another order than the plain index_add_)",
              within_tol=ok3, repeatable=rep3,
              ms=time_cuda(torch, lambda: bw.banded_sample_backward(
                  coefs, *cts, A), flush),
              plain_ms=time_cuda(
                  torch, lambda: bw.banded_sample_backward_reference(
                      coefs, *cts, A), flush, iters=5),
              bytes=nbytes, flops=flops, kept_samples=n_keep,
              samples_per_cell_max=max_hits, samples_per_cell_mean=mean_hits)
    k3["bound_ms"], k3["bound_by"] = bound(nbytes, flops)
    emit(k3)
    if not (ok3 and rep3):
        fail(f"K3 at slot {slot}: max abs {abs3}, max rel {rel3} against its "
             f"plain version, repeatable {rep3}")
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
        rep1 = repeatable(torch, got, kernel)
        abs_err, rel_err, ok = moment_error(got, want)
        bound_ms, bound_by, nbytes, flops = k1_bound(torch, bw, sat_k, grd,
                                                     mask, coefs, True)
        row = dict(phase="kernel_check", kernel="banded_moments", slot=slot,
                   shape=dict(B=BATCH, A=A, C=C, V=V, W=W, RB=RB),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   tol=f"|err| <= {KERNEL_TOL} * column max + 1e-6",
                   within_tol=ok, repeatable=rep1,
                   ms=time_cuda(torch, kernel, flush),
                   plain_ms=time_cuda(torch, plain, flush, iters=5),
                   wrapper_ms=time_cuda(torch, wrapper, flush),
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, rows_zeroed_by_guard=int(
                       (coefs[..., 0] == 1e9).sum()))
        emit(row)
        if not (ok and rep1):
            fail(f"K1 at slot {slot}: max abs {abs_err}, max rel {rel_err} "
                 f"against its plain version, repeatable {rep1}")
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


def edge_line_coefs(torch, A, dev):
    """Hand-made rows [2, 11, 8] of the banded kernels' contract, x = ax +
    bx*u, y = ay + by*u, each a case their tile or split logic must get
    right: bx = by = 0 (every sample on one cell); |bx| = 0.05 and 1e-7;
    negative bx and by; a start on integer coordinates that are tile
    borders; lines along x = A-2 and y = A-2 (the edge quirk keeps them,
    their corners on the last column or row); a guard-zeroed row (ax =
    1e9); a steep line with negative bx; a line entering the map late.
    The second image shifts every unguarded row by 1/8 cell."""
    rows = [(A / 2 + 0.3, 0.0, A / 3 + 0.6, 0.0),
            (1.5, 0.05, 9.25, 0.02),
            (0.5, 1e-7, 17.5, 0.03),
            (A - 2.5, -0.7, A - 3.2, -0.3),
            (8.0, 0.5, 16.0, 0.25),
            (A - 2.0, 0.0, 1.0, 0.4),
            (0.5, 0.45, A - 2.0, 0.0),
            (1e9, 0.5, 3.0, 0.2),
            (A - 1.5, -0.9, 2.0, 0.6),
            (24.0, -1e-7, 40.0, -0.05),
            (-3.0, 0.25, 8.0, 0.125)]
    coefs = torch.zeros(2, len(rows), 8, dtype=torch.float32)
    coefs[:, :, :4] = torch.tensor(rows, dtype=torch.float32)
    live = coefs[1, :, 0] < 1e8
    coefs[1, live, 0] += 0.125
    return coefs.to(dev)


def phase_kernel_edge_lines(torch, dev):
    """K1, K2 and K3 against their plain versions on ``edge_line_coefs`` at
    A = 64, each flagship C and W in {24, 130, 512} (W = 24 is shorter than
    one K1 block's share of samples, 130 no multiple of its split): K1 and
    K2 on a transposed bf16 and fp32 map, K1 under a ray mask with zeros and
    one row masked whole; K1 and K3 launched twice, bit for bit."""
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    A = 64
    gen = torch.Generator(device=dev).manual_seed(4)
    coefs = edge_line_coefs(torch, A, dev)
    B, V = coefs.shape[:2]
    cases, bad = [], []
    for C in (256, 128, 64):
        for W in (24, 130, 512):
            sat = torch.randn(B, A, A, C, generator=gen, device=dev)
            grd = torch.randn(B, V, W, C, generator=gen, device=dev)
            mask = (torch.rand(V, W, generator=gen, device=dev) > 0.2).float()
            mask[4] = 0.0
            cts = torch.randn(3, B, V, W, C, generator=gen, device=dev)
            _, n_keep, max_hits, _ = cell_stats(
                torch, bw._line_cells(coefs, W, A), A, A)
            case = dict(C=C, W=W, kept_samples=n_keep,
                        samples_per_cell_max=max_hits)
            for name, dtype in (("bf16", torch.bfloat16),
                                ("fp32", torch.float32)):
                sat_k = sat.to(dtype).transpose(1, 2)
                bf16 = dtype == torch.bfloat16

                def k1():
                    return bw.moments_from_coefs(sat_k, grd, mask, coefs,
                                                 bf16_map=bf16)

                got = k1()
                rep1 = repeatable(torch, got, k1)
                _, rel1, ok1 = moment_error(
                    got, bw.moments_from_coefs_reference(sat_k, grd, mask,
                                                         coefs))
                got = bw.banded_sample_forward(sat_k, coefs, W, with_dxy=True)
                want = bw.banded_sample_reference(sat_k, coefs, W, True)
                torch.cuda.synchronize()
                _, rel2, ok2 = max_error(got, want, SAMPLER_TOL)
                case[f"k1_{name}"] = dict(max_rel_err=rel1, within_tol=ok1,
                                          repeatable=rep1)
                case[f"k2_{name}"] = dict(max_rel_err=rel2, within_tol=ok2)
                bad += [f"{k} {name} C={C} W={W}" for k, good in
                        (("K1", ok1 and rep1), ("K2", ok2)) if not good]
            got = bw.banded_sample_backward(coefs, *cts, A)
            rep3 = repeatable(torch, got, lambda: bw.banded_sample_backward(
                coefs, *cts, A))
            _, rel3, ok3 = max_error(
                [got], [bw.banded_sample_backward_reference(coefs, *cts, A)],
                SAMPLER_TOL)
            case["k3"] = dict(max_rel_err=rel3, within_tol=ok3,
                              repeatable=rep3)
            if not (ok3 and rep3):
                bad.append(f"K3 C={C} W={W}")
            cases.append(case)
    emit(dict(phase="kernel_edge_lines", A=A, B=B, rows=V,
              tol=dict(k1=f"|err| <= {KERNEL_TOL} * column max + 1e-6",
                       k2_k3=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6"),
              cases=cases))
    if bad:
        fail("kernel_edge_lines: disagrees with the plain version or is not "
             "repeatable: " + ", ".join(bad))


def g2sp_lines(torch, cfg, slot, pose, camera_k):
    """(A, AY, AX, j0, coefs [B, A-j0, 16]) of the G2SP lines of one level
    at these poses, as ``LMG2SP._solver_round`` packs them."""
    from highlyaccurate_tpu_torch.geometry import kitti as geom
    from highlyaccurate_tpu_torch.models.lm_s2gp import _level_hw
    from highlyaccurate_tpu_torch.ops import projline as tpl
    A = cfg.sat_size >> (3 - slot)
    AY, AX = _level_hw(cfg, slot)
    ranges = (cfg.rotation_range, cfg.shift_range_lat, cfg.shift_range_lon)
    j0 = geom.g2sp_inview_col_start(A, AY, AX, *ranges)
    xyz1 = torch.from_numpy(geom.warp_sat2real(A)[:, j0:]).to(pose.device)
    P = geom.g2sp_P(pose, camera_k, AY, AX, cfg.grd_h, cfg.grd_w, *ranges)

    def project(X):
        return (P[:, None, :, :] * X[None, :, None, :]).sum(-1)

    h0, dh = project(xyz1[0]), project(xyz1[1] - xyz1[0])
    return A, AY, AX, j0, h0, dh, tpl.pack_projline_coefs(h0, dh, AY, AX,
                                                          AY, A)


def projline_checks(torch, tpl, grd_k, coefs, W, gen, flush, slot):
    """K4 and K5 on the ground map and lines of one flagship G2SP level,
    each against its plain version on the card, timed beside its bound.
    K4 is timed as serving launches it (out, dx, dy) and, for training,
    with dxy.  Returns the two kernel_check rows."""
    B, AY, AX, C = grd_k.shape
    V = coefs.shape[1]
    cells = tpl._projline_cells(coefs, W, AY, AX)
    touched, n_keep, max_hits, mean_hits = cell_stats(torch, cells, AY, AX)
    tiles, tiles_touched, tile_max = tile_stats(torch, cells, AY, AX)
    del cells
    shape = dict(B=B, AY=AY, AX=AX, C=C, V=V, W=W)
    out_bytes = B * V * W * C * 4

    got = tpl.projline_sample_forward(grd_k, coefs, W, with_dxy=True)
    want = tpl.projline_sample_reference(grd_k, coefs, W, with_dxy=True)
    torch.cuda.synchronize()
    abs4, rel4, ok4 = max_error(got, want, SAMPLER_TOL)
    del got, want
    # the map corners the kept samples touch, coefs, the outputs written
    in_bytes = touched * C * grd_k.element_size() + coefs.numel() * 4
    k4 = dict(phase="kernel_check", kernel="projline_sample", slot=slot,
              shape=shape, outputs="out, dx, dy (and dxy)",
              max_abs_err=abs4, max_rel_err=rel4,
              tol=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6 per output",
              within_tol=ok4,
              ms=time_cuda(torch, lambda: tpl.projline_sample_forward(
                  grd_k, coefs, W, with_dxy=False), flush),
              plain_ms=time_cuda(torch, lambda: tpl.projline_sample_reference(
                  grd_k, coefs, W, False), flush, iters=5),
              ms_dxy=time_cuda(torch, lambda: tpl.projline_sample_forward(
                  grd_k, coefs, W, with_dxy=True), flush),
              bytes=in_bytes + 3 * out_bytes,
              flops=(K2_FLOPS_KEPT - 3) * n_keep * C,
              bytes_dxy=in_bytes + 4 * out_bytes,
              flops_dxy=K2_FLOPS_KEPT * n_keep * C, kept_samples=n_keep,
              samples=B * V * W)
    k4["bound_ms"], k4["bound_by"] = bound(k4["bytes"], k4["flops"])
    k4["bound_ms_dxy"], _ = bound(k4["bytes_dxy"], k4["flops_dxy"])
    emit(k4)
    if not ok4:
        fail(f"K4 disagrees with its plain version at slot {slot}: "
             f"max abs {abs4}, max rel {rel4}")

    cts = torch.randn(3, B, V, W, C, generator=gen, device=grd_k.device)
    got = tpl.projline_sample_backward(coefs, *cts, AY, AX)
    want = tpl.projline_sample_backward_reference(coefs, *cts, AY, AX)
    rep5 = repeatable(torch, got, lambda: tpl.projline_sample_backward(
        coefs, *cts, AY, AX))
    abs5, rel5, ok5 = max_error([got], [want], SAMPLER_TOL)
    del got, want
    # the kept samples' three cotangents, coefs, the gradient written
    nbytes = 3 * n_keep * C * 4 + coefs.numel() * 4 + B * AY * AX * C * 4
    flops = K3_FLOPS_KEPT * n_keep * C
    k5 = dict(phase="kernel_check", kernel="projline_sample_backward",
              slot=slot, shape=shape, max_abs_err=abs5, max_rel_err=rel5,
              tol=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6 (each map "
              "cell's sum in another order than the plain index_add_)",
              within_tol=ok5, repeatable=rep5,
              ms=time_cuda(torch, lambda: tpl.projline_sample_backward(
                  coefs, *cts, AY, AX), flush),
              plain_ms=time_cuda(
                  torch, lambda: tpl.projline_sample_backward_reference(
                      coefs, *cts, AY, AX), flush, iters=5),
              bytes=nbytes, flops=flops, kept_samples=n_keep,
              samples_per_cell_max=max_hits, samples_per_cell_mean=mean_hits,
              tiles=tiles, tiles_touched=tiles_touched,
              samples_per_tile_max=tile_max)
    k5["bound_ms"], k5["bound_by"] = bound(nbytes, flops)
    emit(k5)
    if not (ok5 and rep5):
        fail(f"K5 at slot {slot}: max abs {abs5}, max rel {rel5} against its "
             f"plain version, repeatable {rep5}")
    return k4, k5


def lane_error(got, want):
    """(max abs error, max error over each lane's max|plain|, within
    |err| <= SAMPLER_TOL * max|plain lane| + 1e-6) of [..., L] moments."""
    err = (got - want).abs().flatten(0, -2).amax(0)
    scale = want.abs().flatten(0, -2).amax(0)
    ok = bool((err <= SAMPLER_TOL * scale + 1e-6).all())
    return float(err.max()), float((err / scale.clamp_min(1e-30)).max()), ok


def pixmom_check(torch, tpl, grd_k, tgt, coefs, W, flush, slot):
    """K6 on the ground map, target rows and lines of one flagship G2SP
    level against its plain version on the card, and against K4's out, dx,
    dy contracted in torch; timed beside its bound.  Returns the
    kernel_check row."""
    B, AY, AX, C = grd_k.shape
    V = coefs.shape[1]
    touched, n_keep, _, _ = cell_stats(
        torch, tpl._projline_cells(coefs, W, AY, AX), AY, AX)
    got = tpl.projline_pixmom(grd_k, tgt, coefs, W)
    want = tpl.projline_pixmom_reference(grd_k, tgt, coefs, W)
    via_k4 = torch.stack(tpl.pixel_moments(*tpl.projline_sample_forward(
        grd_k, coefs, W, with_dxy=False), tgt), -1)
    rep6 = repeatable(torch, got, lambda: tpl.projline_pixmom(
        grd_k, tgt, coefs, W))
    abs6, rel6, ok6 = lane_error(got, want)
    abs_k4, rel_k4, ok_k4 = lane_error(got, via_k4)
    del got, want, via_k4
    # the map corners and target rows of the kept samples, coefs, the five
    # moments written
    nbytes = (touched * C * grd_k.element_size() + n_keep * C * 4
              + coefs.numel() * 4 + B * V * W * len(tpl.PIXMOM_IDX) * 4)
    flops = K6_FLOPS_KEPT * n_keep * C
    row = dict(phase="kernel_check", kernel="projline_pixmom", slot=slot,
               shape=dict(B=B, AY=AY, AX=AX, C=C, V=V, W=W),
               max_abs_err=abs6, max_rel_err=rel6,
               tol=f"|err| <= {SAMPLER_TOL} * max|plain lane| + 1e-6 per lane",
               within_tol=ok6, repeatable=rep6,
               k4_contracted_max_abs_err=abs_k4,
               k4_contracted_max_rel_err=rel_k4, k4_contracted_within_tol=ok_k4,
               ms=time_cuda(torch, lambda: tpl.projline_pixmom(
                   grd_k, tgt, coefs, W), flush),
               plain_ms=time_cuda(torch, lambda: tpl.projline_pixmom_reference(
                   grd_k, tgt, coefs, W), flush, iters=5),
               bytes=nbytes, flops=flops, kept_samples=n_keep,
               samples=B * V * W)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    emit(row)
    if not (ok6 and ok_k4 and rep6):
        fail(f"K6 at slot {slot}: with its plain version max abs {abs6} "
             f"(rel {rel6}), with K4 contracted max abs {abs_k4} (rel "
             f"{rel_k4}), repeatable {rep6}")
    return row


def projline_vjp_check(torch, tpl, grd, h0, dh, W, gen):
    """The projective-line sampler's whole VJP (K4 with dxy, K5 and the
    coefficient gradients, through ``pack_projline_coefs``) against
    autograd through the plain forward, on a bf16-exact fp32 map (so the
    cast inside the function changes nothing)."""
    AY, AX = grd.shape[1:3]
    leaves = [t.detach().requires_grad_() for t in
              (grd.to(torch.bfloat16).float(), h0, dh)]
    cts = torch.randn(3, grd.shape[0], h0.shape[1], W, grd.shape[3],
                      generator=gen, device=grd.device)

    def grads(sample):
        coefs = tpl.pack_projline_coefs(leaves[1], leaves[2], AY, AX, AY, W)
        loss = sum((o * c).sum() for o, c in zip(sample(coefs), cts))
        return torch.autograd.grad(loss, leaves)

    got = grads(lambda c: tpl.projline_sample(leaves[0], c, W=W))
    want = grads(lambda c: tpl.projline_sample_reference(leaves[0], c, W,
                                                         False))
    errs = {}
    for name, g, w in zip(("map", "h0", "dh"), got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        errs[name] = dict(max_abs_err=err, max_rel_err=err / max(scale, 1e-30))
        if err > VJP_TOL * scale:
            fail(f"projline VJP: d/d{name} differs from autograd by {err} "
                 f"(max {scale})")
    return errs


def phase_g2sp_kernels(torch, dev, flush):
    """K4, K5 and K6 at the three flagship G2SP levels (lines from
    ``g2sp_P`` at random in-range poses with the default K; K6's target a
    transposed view of a satellite map, as the model passes it), and the
    projective-line VJP at the middle one."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
    from highlyaccurate_tpu_torch.ops import projline as tpl

    cfg = Config(direction="G2SP")
    gen = torch.Generator(device=dev).manual_seed(3)
    k = torch.from_numpy(_scaled_default_k(cfg)).to(dev).expand(BATCH, 3, 3)
    rows = {"projline_sample": [], "projline_sample_backward": [],
            "projline_pixmom": []}
    for slot, C in zip((0, 1, 2), (256, 128, 64)):
        pose = torch.rand(BATCH, 3, generator=gen, device=dev) * 2 - 1
        A, AY, AX, j0, h0, dh, coefs = g2sp_lines(torch, cfg, slot, pose, k)
        grd = torch.randn(BATCH, AY, AX, C, generator=gen, device=dev)
        k4, k5 = projline_checks(torch, tpl, grd.to(torch.bfloat16), coefs,
                                 A, gen, flush, slot)
        sat = torch.randn(BATCH, A, A, C, generator=gen, device=dev)
        k6 = pixmom_check(torch, tpl, grd.to(torch.bfloat16),
                          sat[:, :, j0:].transpose(1, 2), coefs, A, flush,
                          slot)
        del sat
        k4["shape"]["j0"] = k5["shape"]["j0"] = k6["shape"]["j0"] = j0
        rows["projline_sample"].append(k4)
        rows["projline_sample_backward"].append(k5)
        rows["projline_pixmom"].append(k6)
        if slot == 1:
            emit(dict(phase="projline_vjp", slot=slot, shape=k4["shape"],
                      map="bf16-exact float32", tol=f"|err| <= {VJP_TOL} * max",
                      grads=projline_vjp_check(torch, tpl, grd, h0, dh, A,
                                               gen)))
    return rows


# Hand-made projective lines (nx0, dnx, ny0, dny, d0, dd) on a 32 x 128
# ground map, x = (nx0 + dnx*u) / den, y = (ny0 + dny*u) / den, den = d0 +
# dd*u; where a coordinate is meant to land on integers it is exact in fp32
EDGE_PROJLINES = (
    (-55.0, 6.0, -19.0, 2.0, -1.0, 0.1),   # pole at u = 10: behind the camera
                                           # before (x, y in the map there),
                                           # then in front, toward (60, 20)
    (36.0, 0.5, 12.0, 0.3, 1.2, -0.1),     # in front until its pole at u = 12
    (7.0, 1.75, 5.0, 0.375, 2.0, 0.0),     # dd = 0: x = 3.5 + 0.875u, exact
    (100.0, 0.0, 5.0, 0.15, 1.0, 0.02),    # dnx = 0
    (15.0, 0.7, 24.0, 0.0, 1.5, 0.01),     # dny = 0
    (5.0, 20.15, 12.5, 1.85, 0.5, 0.5),    # converges on cell (40, 3):
                                           # dozens of samples per cell
    (16.0, 1.0, 8.0, 0.5, 1.0, 0.0),       # starts on a tile corner, crosses
                                           # tile borders on integers
    (126.0, 0.0, 0.5, 0.25, 1.0, 0.0),     # along x = AX-2 (edge quirk keeps)
    (0.25, 0.625, 30.0, 0.0, 1.0, 0.0),    # along y = AY-2
    (1e9, 0.0, 3.0, 0.2, 1.0, 0.0),        # a guard line
    (64.5, -0.3, 3.0, 0.1, 1.0, 1e-7),     # |dd| = 1e-7
    (20.0, 0.45, 28.0, -0.1, 1.0, -1e-7),
    (120.0, -0.8, 30.0, -0.15, 1.0, 0.003),  # x and y decreasing
    (-30.0, 0.6, 2.0, 0.12, 1.0, 0.0),     # enters the map late
)
EDGE_AY, EDGE_AX = 32, 128


def edge_projlines():
    """The lines of ``EDGE_PROJLINES`` as (h0, dh) [2, V, 3] float32 numpy
    (h = h0 + u*dh = (nx0 + dnx*u, ny0 + dny*u, d0 + dd*u)); the second
    image shifts every line but the guard line by 1/8 cell at u = 0."""
    lines = np.asarray(EDGE_PROJLINES, np.float64)
    h0 = np.repeat(lines[None, :, 0::2], 2, axis=0)
    dh = np.repeat(lines[None, :, 1::2], 2, axis=0)
    live = lines[:, 0] < 1e8
    h0[1, live, 0] += 0.125 * lines[live, 4]
    return h0.astype(np.float32), dh.astype(np.float32)


def edge_projline_coefs(torch, dev):
    """``edge_projlines`` written straight into lanes 0-5 of [2, V, 16]
    coefficients (the kernels read no others)."""
    h0, dh = edge_projlines()
    coefs = np.zeros(h0.shape[:2] + (16,), np.float32)
    coefs[..., 0:6:2], coefs[..., 1:6:2] = h0, dh
    return torch.from_numpy(coefs).to(dev)


def phase_kernel_edge_projlines(torch, dev):
    """K4, K5 and K6 against their plain versions on ``edge_projlines`` at
    AY x AX = 32 x 128, C in {256, 128, 64} and W in {24, 130, 256}: K4 on
    a bf16 and an fp32 map, with dxy; K6 on a transposed target view, also
    against K4 contracted in torch; K5 and K6 launched twice, bit for
    bit."""
    from highlyaccurate_tpu_torch.ops import projline as tpl
    AY, AX = EDGE_AY, EDGE_AX
    gen = torch.Generator(device=dev).manual_seed(5)
    coefs = edge_projline_coefs(torch, dev)
    B, V = coefs.shape[:2]
    cases, bad = [], []
    for C in (256, 128, 64):
        for W in (24, 130, 256):
            grd = torch.randn(B, AY, AX, C, generator=gen, device=dev)
            sat = torch.randn(B, W, V + 3, C, generator=gen, device=dev)
            tgt = sat[:, :, 3:].transpose(1, 2)
            cts = torch.randn(3, B, V, W, C, generator=gen, device=dev)
            cells = tpl._projline_cells(coefs, W, AY, AX)
            _, n_keep, max_hits, _ = cell_stats(torch, cells, AY, AX)
            _, tiles_touched, tile_max = tile_stats(torch, cells, AY, AX)
            case = dict(C=C, W=W, kept_samples=n_keep,
                        samples_per_cell_max=max_hits,
                        tiles_touched=tiles_touched,
                        samples_per_tile_max=tile_max)
            for name, dtype in (("bf16", torch.bfloat16),
                                ("fp32", torch.float32)):
                grd_k = grd.to(dtype)
                got = tpl.projline_sample_forward(grd_k, coefs, W,
                                                  with_dxy=True)
                want = tpl.projline_sample_reference(grd_k, coefs, W, True)
                torch.cuda.synchronize()
                _, rel4, ok4 = max_error(got, want, SAMPLER_TOL)
                case[f"k4_{name}"] = dict(max_rel_err=rel4, within_tol=ok4)
                if not ok4:
                    bad.append(f"K4 {name} C={C} W={W}")
            got = tpl.projline_sample_backward(coefs, *cts, AY, AX)
            rep5 = repeatable(torch, got, lambda: tpl.projline_sample_backward(
                coefs, *cts, AY, AX))
            _, rel5, ok5 = max_error(
                [got], [tpl.projline_sample_backward_reference(coefs, *cts,
                                                                AY, AX)],
                SAMPLER_TOL)
            case["k5"] = dict(max_rel_err=rel5, within_tol=ok5,
                              repeatable=rep5)
            grd_k = grd.to(torch.bfloat16)
            got = tpl.projline_pixmom(grd_k, tgt, coefs, W)
            rep6 = repeatable(torch, got, lambda: tpl.projline_pixmom(
                grd_k, tgt, coefs, W))
            _, rel6, ok6 = lane_error(
                got, tpl.projline_pixmom_reference(grd_k, tgt, coefs, W))
            _, rel_k4, ok_k4 = lane_error(got, torch.stack(tpl.pixel_moments(
                *tpl.projline_sample_forward(grd_k, coefs, W,
                                             with_dxy=False), tgt), -1))
            case["k6"] = dict(max_rel_err=rel6, within_tol=ok6,
                              repeatable=rep6, k4_contracted_max_rel_err=rel_k4,
                              k4_contracted_within_tol=ok_k4)
            bad += [f"{k} C={C} W={W}" for k, good in
                    (("K5", ok5 and rep5), ("K6", ok6 and ok_k4 and rep6))
                    if not good]
            cases.append(case)
    emit(dict(phase="kernel_edge_projlines", AY=AY, AX=AX, B=B, lines=V,
              tol=dict(k4_k5=f"|err| <= {SAMPLER_TOL} * max|plain| + 1e-6",
                       k6=f"|err| <= {SAMPLER_TOL} * max|plain lane| + 1e-6 "
                       "per lane"),
              cases=cases))
    if bad:
        fail("kernel_edge_projlines: disagrees with the plain version or is "
             "not repeatable: " + ", ".join(bad))


def serve_images(cfg, seed, n):
    """Seeded uint8 satellite and ground images, n of each."""
    rng = np.random.RandomState(seed)
    sat = (rng.rand(n, cfg.sat_size, cfg.sat_size, 3) * 255).astype(np.uint8)
    grd = (rng.rand(n, cfg.grd_h, cfg.grd_w, 3) * 255).astype(np.uint8)
    return sat, grd


def first_batch(torch, dev, sat, grd):
    """The first BATCH images as the float32 tensors predict makes."""
    return tuple(torch.from_numpy(a[:BATCH].astype(np.float32) / 255.0)
                 .to(dev) for a in (sat, grd))


def serve_window(torch, loc, sat, grd, what, expected):
    """One warm-up batch, then one timed ``predict`` over all the images
    with the launch counts reset: (outputs, wall s, launches, peak GB).
    Fails unless the kernels launched exactly as ``expected`` per batch."""
    n_batches = sat.shape[0] // BATCH
    loc.predict(sat[:BATCH], grd[:BATCH])  # warm-up (cuDNN algorithm pick)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = loc.predict(sat, grd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_launches(what, {k: v * n_batches
                                    for k, v in expected.items()})
    for key, v in out.items():
        if v.shape != (sat.shape[0],) or not np.isfinite(v).all():
            fail(f"{what} {key}: shape {v.shape} or non-finite values")
    return out, wall, counts, torch.cuda.max_memory_allocated() / 1e9


def split_ms(torch, model, s8, g8, forward):
    """Device ms of the features alone and of the whole ``forward`` of one
    batch (CUDA events)."""
    flush = torch.empty(1, device=s8.device)
    with torch.no_grad():
        return (time_cuda(torch, lambda: model.extract_features(s8, g8),
                          flush, iters=5, warm=1),
                time_cuda(torch, forward, flush, iters=5, warm=1))


def serve_row(phase, config, window, split, init_s, **extra):
    """The JSON line of a serving phase: ``window`` from serve_window,
    ``split`` from split_ms."""
    out, wall, counts, peak_gb = window
    n = out["lateral_m"].shape[0]
    n_batches = n // BATCH
    row = dict(phase=phase, config=config, batch=BATCH, batches=n_batches,
               images=n, wall_s=wall, frames_per_s=n / wall,
               ms_per_batch=wall / n_batches * 1e3)
    for k, v in counts.items():
        if v:
            row[f"{k}_launches"] = v
            row[f"{k}_launches_per_batch"] = v // n_batches
    row.update(features_ms_per_batch=split[0], forward_ms_per_batch=split[1],
               solver_ms_per_batch=split[1] - split[0], peak_mem_gb=peak_gb,
               init_s=init_s, **extra,
               lateral_m_first=out["lateral_m"][:4].tolist())
    emit(row)
    return row


def traj_vs_cpu(torch, card_traj, cpu_traj, tol, what):
    """Round-1 and all-round pose differences of the card's trajectory
    against the CPU's at batch 2, beside the card with TF32 convolutions (a
    known perturbation for scale); fails if round 1 differs by more than
    ``tol``.  Where the model re-inits, the two generators draw different
    numbers, so a re-init in round 1 fails as loudly as a wrong kernel."""
    with torch.no_grad():
        t0 = time.perf_counter()
        tc = cpu_traj()
        cpu_s = time.perf_counter() - t0
        tg = card_traj()
        torch.backends.cudnn.allow_tf32 = True
        try:
            tt = card_traj()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    tc, tg, tt = (torch.stack(t, -1).cpu().numpy() for t in (tc, tg, tt))
    if not all(np.isfinite(t).all() for t in (tc, tg, tt)):
        fail(f"non-finite {what} trajectory")
    d = np.abs(tg - tc)
    round1 = float(d[:, 0, 0].max())
    if round1 > tol:
        fail(f"{what} round-1 pose differs between card and CPU by {round1}")
    return dict(batch=2, round1_max_abs=round1,
                all_rounds_max_abs=float(d.max()), round1_tol=tol,
                round1_max_abs_tf32_convs=float(
                    np.abs(tt - tc)[:, 0, 0].max()), cpu_s=cpu_s)


def cpu_twin(family, model):
    """A CPU copy of ``model`` (same family, config and weights)."""
    cpu = family(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def phase_main_path(torch, dev):
    """S2GP serving at full width: ``Localizer(Config())`` predicts a window
    of seeded batches (K1 exactly 15 times per batch, no other kernel); the
    first-round moments of every level on the real features against the
    plain version; the trajectory of the card against a CPU run at batch
    2."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.geometry.kitti import s2gp_uv_jac
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP, banded_project
    from highlyaccurate_tpu_torch.ops import banded_warp as bw

    cfg = Config()
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0)
    init_s = time.perf_counter() - t0
    sat, grd = serve_images(cfg, 0, BATCH * N_BATCHES)
    window = serve_window(torch, loc, sat, grd, "S2GP serving",
                          {"k1": cfg.N_iters * cfg.n_levels})
    # the re-init draw every round, as predict makes it
    model, gen = loc.model, loc._generator
    s8, g8 = first_batch(torch, dev, sat, grd)

    def forward():
        return model(s8, g8, mode="test", generator=gen)

    split = split_ms(torch, model, s8, g8, forward)
    with torch.no_grad():
        # first-round moments of every level, kernel vs plain, real features
        sf, _, gf, _ = model.extract_features(s8, g8)
        pose0 = torch.zeros(BATCH, 3, device=dev)
        m_err = []
        for lvl, slot in enumerate(model._slots):
            A = sf[lvl].shape[1]
            mask = getattr(model, f"mask_{slot}")
            uv01, duv01 = s2gp_uv_jac(pose0, getattr(model, f"rows01_{slot}"),
                                      A, cfg.rotation_range,
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
    cpu = cpu_twin(LMS2GP, model)
    vs_cpu = traj_vs_cpu(
        torch, lambda: model(s8[:2], g8[:2], mode="trajectory",
                             generator=torch.Generator(device=dev)
                             .manual_seed(0)),
        lambda: cpu(s8[:2].cpu(), g8[:2].cpu(), mode="trajectory",
                    generator=torch.Generator().manual_seed(0)),
        ROUND1_TOL, "S2GP")
    row = serve_row("main_path", "KITTI S2GP geo LM, sat 512, grd 256x1024, "
                    "level 3, N_iters 5, fp32 features, bf16 map, TF32 off",
                    window, split, init_s, first_round_moments=m_err,
                    traj_card_vs_cpu=vs_cpu)
    return row, forward


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

def eval_profile(torch, phase, fn, forward_ms, table, kernels_expected):
    """Device time by kernel over one evaluation forward (torch.profiler).
    The profiler slows the host, so the idle share is also given against
    ``forward_ms``, the same forward timed unprofiled.  Fails unless each
    hand kernel ran as often as ``kernels_expected`` says ({short name:
    (device kernel name, count)})."""
    with torch.no_grad():
        wall_ms, busy_ms, kernels, prof = profiled(torch, fn, table)
    row = dict(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_kernel_ms_sum=sum(e.device_time_total
                                        for e in kernels) / 1e3,
               device_idle_share=1 - busy_ms / wall_ms,
               device_idle_share_unprofiled=1 - busy_ms / forward_ms,
               device_kernels=len(kernels),
               conv_device_ms=conv_device_ms(prof,
                                             ("aten::cudnn_convolution",)))
    for short, (name, want) in kernels_expected.items():
        ms, count = device_ms(kernels, name)
        row[f"{short}_device_ms"], row[f"{short}_launches"] = ms, count
        if count != want:
            fail(f"{phase}: {count} {name} kernels, expected {want}")
    row["table"] = table
    emit(row)


def rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def s2gp_loss(model, batch, generator):
    """The S2GP training forward on batch = (sat, grd, gt)."""
    sat, grd, gt = batch
    return model(sat, grd, mode="train", gt_pose=gt, generator=generator)


def s2gp_depth_loss(model, batch, generator):
    """The S2GP training forward with the ``gt_depth`` lift on batch =
    (sat, grd, gt, gt_depth)."""
    sat, grd, gt, depth = batch
    return model(sat, grd, mode="train", gt_pose=gt, generator=generator,
                 gt_depth=depth)


def g2sp_loss(model, batch, generator):
    """The G2SP training forward on batch = (sat, grd, camera_k, gt); G2SP
    never re-inits, so it takes no generator."""
    del generator
    sat, grd, camera_k, gt = batch
    return model(sat, grd, camera_k, mode="train", gt_pose=gt)


def train_grads(torch, model, loss_of, batch, generator):
    """Loss and every parameter's gradient (None: no gradient) of one
    training forward and backward, without an optimizer step."""
    model.zero_grad(set_to_none=True)
    out = loss_of(model, batch, generator)
    out.loss.backward()
    return float(out.loss.detach()), {k: None if p.grad is None
                             else p.grad.detach().float().cpu()
                             for k, p in model.named_parameters()}


def feature_maps(model, sat, grd):
    """The two networks' feature pyramids, satellite levels then ground."""
    sf, _, gf, _ = model.extract_features(sat, grd)
    return [*sf, *gf]


def solver_grads(torch, model, feats, loss_of, batch, generator):
    """The loss of the solver rounds on the given feature maps (the
    networks bypassed) and its gradient with respect to each map."""
    leaves = [f.detach().requires_grad_() for f in feats]
    n = len(leaves) // 2
    model.extract_features = lambda s, g: (leaves[:n], None, leaves[n:], None)
    try:
        loss = loss_of(model, batch, generator).loss
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


def card_vs_cpu(torch, family, cfg, weights, batch, dev, loss_of,
                plain_kernels):
    """One train step of the card against a CPU run of the port, on the
    same weights and data, each part beside a known perturbation for
    scale:
    * end to end: the loss and every parameter's gradient (and with TF32
      convolutions);
    * the solver alone on the CPU's feature maps: the loss and the feature
      gradients (and the card with the sampler kernels' plain versions in
      place of the kernels, which differ from them in the last bits only:
      ``plain_kernels`` is a context manager that swaps them in);
    * the networks alone under the CPU's feature gradients: every
      parameter's gradient (and with TF32 convolutions)."""
    cpu = family(cfg, device="cpu")
    cpu.load_state_dict(weights)
    card = family(cfg, device=dev)
    card.load_state_dict(weights)
    sat, grd = batch[:2]
    cbatch = [t.cpu() for t in batch]
    t0 = time.perf_counter()
    feats_c = feature_maps(cpu, *cbatch[:2])
    loss_c, fg_c = solver_grads(torch, cpu, feats_c, loss_of, cbatch,
                                torch.Generator().manual_seed(0))
    pg_c = {k: g for k, g in net_grads(torch, cpu, *cbatch[:2], fg_c).items()
            if g is not None}
    cpu_s = time.perf_counter() - t0

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def end_to_end():
        loss, grads = train_grads(torch, card, loss_of, batch, gen())
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
                                   loss_of, batch, gen())
        return loss, grads, dict(
            loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
            feature_grad_rel_l2_max=max(
                rel_l2(g, r) for g, r in zip(grads, ref_grads)))

    row = dict(cpu_loss=loss_c, params_compared=len(pg_c), cpu_s=cpu_s,
               end_to_end=end_to_end(), end_to_end_tf32=tf32(end_to_end),
               nets_only=nets_only(), nets_only_tf32=tf32(nets_only))
    loss_s, fg_g, row["solver_only"] = solver_only(loss_c, fg_c)
    with plain_kernels():
        row["solver_only_kernels_vs_plain"] = solver_only(loss_s, fg_g)[2]
    return row


@contextlib.contextmanager
def plain_k2_k3():
    """K2 / K3's plain versions in place of the kernels."""
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    kernels = bw.banded_sample_forward, bw.banded_sample_backward
    bw.banded_sample_forward = (lambda sat_k, coefs, W, *, with_dxy:
                                bw.banded_sample_reference(sat_k, coefs, W,
                                                           with_dxy))
    bw.banded_sample_backward = bw.banded_sample_backward_reference
    try:
        yield
    finally:
        bw.banded_sample_forward, bw.banded_sample_backward = kernels


@contextlib.contextmanager
def plain_k4_k5():
    """K4 / K5's plain versions in place of the kernels."""
    from highlyaccurate_tpu_torch.ops import projline as tpl
    kernels = tpl.projline_sample_forward, tpl.projline_sample_backward
    tpl.projline_sample_forward = (lambda grd_k, coefs, W, *, with_dxy:
                                   tpl.projline_sample_reference(
                                       grd_k, coefs, W, with_dxy))
    tpl.projline_sample_backward = tpl.projline_sample_backward_reference
    try:
        yield
    finally:
        tpl.projline_sample_forward, tpl.projline_sample_backward = kernels


def check_limits(what, row, limits):
    """Fail unless every (part, reading) of ``row`` is within its limit."""
    failed = [f"{part} {key} {row[part][key]} > {tol}"
              for (part, key), tol in limits.items()
              if not row[part][key] <= tol]
    if failed:
        fail(f"{what}, card vs CPU: " + "; ".join(failed))

def train_phase(torch, dev, phase, config, family, cfg, seed, steps, extras,
                loss_of, plain_kernels, limits, expected, **step_kw):
    """A training step at full width, batch 8, through
    ``make_train_step(model, cfg, **step_kw)`` on seeded images and gt
    poses: one warm-up step, then one timed window of ``steps`` steps that
    must launch each kernel of ``expected`` exactly 15 times per step (and
    no other); steps/s, images/s, ms/step, a forward / backward / optimizer
    split, peak memory, the losses; then one step of the card against a
    CPU run of the port at batch 2 (``card_vs_cpu``) within ``limits``.
    ``extras(n)`` gives the per-image inputs between the images and the gt
    (camera_k, or R_FL and T_FL) for n images."""
    from highlyaccurate_tpu_torch.params import init_params
    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    model = family(cfg, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg, **step_kw)
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    n = steps + 1
    sat = torch.from_numpy((rng.rand(n, BATCH, cfg.sat_size, cfg.sat_size, 3)
                            * 255).astype(np.uint8)).to(dev).float() / 255.0
    grd = torch.from_numpy((rng.rand(n, BATCH, cfg.grd_h, cfg.grd_w, 3)
                            * 255).astype(np.uint8)).to(dev).float() / 255.0
    gt = torch.from_numpy(rng.uniform(-1, 1, (n, BATCH, 3)).astype(
        np.float32)).to(dev)
    ext = extras(BATCH)
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(i):
        return (sat[i], grd[i], *ext, gt[i])

    state, m = step(state, *batch(0), gen)  # warm-up
    torch.cuda.synchronize()
    first_loss = float(m["loss"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(1, n):
        state, m = step(state, *batch(i), gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = cfg.N_iters * cfg.n_levels
    counts = expect_launches(phase, {k: per_step * steps for k in expected})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first_loss] + [float(v) for v in losses]
    if not np.isfinite(losses).all():
        fail(f"{phase}: non-finite train loss: {losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail(f"{phase}: non-finite parameters after training")

    # forward / backward / optimizer split of one step (CUDA events; each
    # span also holds the time the device waits on the host)
    opt = state.optimizer
    spans = []
    for i in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        out = loss_of(model, batch(i), gen)
        ev[1].record()
        out.loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        spans.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
    fwd_ms, bwd_ms, opt_ms = np.median(np.array(spans), axis=0).tolist()
    step_ms = wall / steps * 1e3
    row = dict(phase=phase, config=config, batch=BATCH, steps=steps,
               wall_s=wall, steps_per_s=steps / wall,
               images_per_s=steps * BATCH / wall, ms_per_step=step_ms)
    for k in expected:
        row[f"{k}_launches"] = counts[k]
        row[f"{k}_launches_per_step"] = counts[k] // steps
    row.update(forward_ms=fwd_ms, backward_ms=bwd_ms, optimizer_ms=opt_ms,
               peak_mem_gb=peak_gb, init_s=init_s, first_loss=losses[0],
               last_loss=losses[-1], losses=losses)
    emit(row)

    # the card against a CPU run of the port at batch 2, on the initial
    # weights and the first batch's data
    b = TRAIN_CHECK_BATCH
    check = card_vs_cpu(torch, family, cfg, weights,
                        tuple(t[:b] for t in batch(0)), dev, loss_of,
                        plain_kernels)
    emit(dict(phase=f"{phase}_card_vs_cpu", batch=b, **check, limits={
        f"{part}.{key}": tol for (part, key), tol in limits.items()}))
    check_limits(f"{phase} step", check, limits)
    return dict(counts, ms_per_step=step_ms, per_step=per_step, state=state,
                step=step, batch=batch(0), gen=gen)


def train_profile(torch, phase, train, table, kernels):
    """Device time by kernel over one train step (torch.profiler), beside
    the unprofiled ms/step of the timed window; ``kernels`` maps each
    short name to its device kernel, which must run 15 times."""
    state = train["state"]

    def one_step():
        nonlocal state
        state, _ = train["step"](state, *train["batch"], train["gen"])

    wall_ms, busy_ms, events, prof = profiled(torch, one_step, table)
    row = dict(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_kernel_ms_sum=sum(e.device_time_total
                                        for e in events) / 1e3,
               device_idle_share=1 - busy_ms / wall_ms,
               device_idle_share_unprofiled=1 - busy_ms / train["ms_per_step"],
               device_kernels=len(events),
               conv_device_ms=conv_device_ms(
                   prof, ("aten::cudnn_convolution",
                          "aten::convolution_backward")))
    for short, name in kernels.items():
        row[f"{short}_device_ms"], row[f"{short}_launches"] = device_ms(
            events, name)
        if row[f"{short}_launches"] != train["per_step"]:
            fail(f"{phase}: {row[f'{short}_launches']} {name} kernels")
    row["table"] = table
    emit(row)

def phase_g2sp_main_path(torch, dev):
    """G2SP serving at full width: ``Localizer(Config(direction="G2SP"))``
    with the default K predicts a window of seeded batches (K4 exactly 15
    times per batch, no other kernel); the first-round K4 samples of every
    level on the real features against the plain version; the trajectory
    of the card against a CPU run of the port at batch 2."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
    from highlyaccurate_tpu_torch.ops import projline as tpl

    cfg = Config(direction="G2SP")
    k = _scaled_default_k(cfg)
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0,
                    camera_k=k)
    init_s = time.perf_counter() - t0
    sat, grd = serve_images(cfg, 2, BATCH * G2SP_BATCHES)
    window = serve_window(torch, loc, sat, grd, "G2SP serving",
                          {"k4": cfg.N_iters * cfg.n_levels})
    model = loc.model
    s8, g8 = first_batch(torch, dev, sat, grd)
    k8 = torch.from_numpy(k).to(dev).expand(BATCH, 3, 3).contiguous()

    def forward():
        return model(s8, g8, k8, mode="test")

    split = split_ms(torch, model, s8, g8, forward)
    with torch.no_grad():
        # first-round samples of every level, kernel vs plain, real features
        sf, _, gf, _ = model.extract_features(s8, g8)
        pose0 = torch.zeros(BATCH, 3, device=dev)
        s_err = []
        for lvl, slot in enumerate(model._slots):
            A, _, _, _, _, _, coefs = g2sp_lines(torch, cfg, slot, pose0, k8)
            grd_k = gf[lvl].to(torch.bfloat16)
            got = tpl.projline_sample_forward(grd_k, coefs, A,
                                              with_dxy=False)
            want = tpl.projline_sample_reference(grd_k, coefs, A, False)
            abs_err, rel_err, ok = max_error(got, want, SAMPLER_TOL)
            if not ok:
                fail(f"G2SP first-round samples disagree at level {lvl}: "
                     f"{abs_err} abs, {rel_err} rel")
            s_err.append(dict(level=lvl, max_abs_err=abs_err,
                              max_rel_err=rel_err))
    cpu = cpu_twin(LMG2SP, model)
    vs_cpu = traj_vs_cpu(
        torch, lambda: model(s8[:2], g8[:2], k8[:2], mode="trajectory"),
        lambda: cpu(s8[:2].cpu(), g8[:2].cpu(), k8[:2].cpu(),
                    mode="trajectory"), G2SP_ROUND1_TOL, "G2SP")
    row = serve_row("g2sp_main_path", "KITTI G2SP geo LM, sat 512, grd "
                    "256x1024, level 3, N_iters 5, default K, fp32 features, "
                    "bf16 map, TF32 off", window, split, init_s,
                    col_start=model._col_start, first_round_samples=s_err,
                    traj_card_vs_cpu=vs_cpu)
    return row, forward

def phase_g2sp_pixmom_main_path(torch, dev):
    """G2SP serving with the fused pixel moments
    (``Config(direction="G2SP", g2sp_pixel_moments=1)``, the default K):
    the weights and images of g2sp_main_path, K6 exactly 15 times per batch
    and no other kernel; the first-round K6 moments of every level on the
    real features against the plain version; the poses against the K4 path
    on the same card, weights and inputs; the trajectory of the card
    against a CPU run of the port at batch 2."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
    from highlyaccurate_tpu_torch.ops import projline as tpl

    cfg = Config(direction="G2SP", g2sp_pixel_moments=1)
    k = _scaled_default_k(cfg)
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0,
                    camera_k=k)
    init_s = time.perf_counter() - t0
    sat, grd = serve_images(cfg, 2, BATCH * G2SP_BATCHES)
    window = serve_window(torch, loc, sat, grd, "G2SP pixel-moment serving",
                          {"k6": cfg.N_iters * cfg.n_levels})
    model = loc.model
    s8, g8 = first_batch(torch, dev, sat, grd)
    k8 = torch.from_numpy(k).to(dev).expand(BATCH, 3, 3).contiguous()

    def forward():
        return model(s8, g8, k8, mode="test")

    split = split_ms(torch, model, s8, g8, forward)
    k4_model = LMG2SP(Config(direction="G2SP"), device=dev)
    k4_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        sf, _, gf, _ = model.extract_features(s8, g8)
        pose0 = torch.zeros(BATCH, 3, device=dev)
        m_err = []
        for lvl, slot in enumerate(model._slots):
            A, _, _, j0, _, _, coefs = g2sp_lines(torch, cfg, slot, pose0, k8)
            grd_k = gf[lvl].to(torch.bfloat16)
            tgt = sf[lvl][:, :, j0:].transpose(1, 2)
            abs_err, rel_err, ok = lane_error(
                tpl.projline_pixmom(grd_k, tgt, coefs, A),
                tpl.projline_pixmom_reference(grd_k, tgt, coefs, A))
            if not ok:
                fail(f"G2SP first-round moments disagree at level {lvl}: "
                     f"{abs_err} abs, {rel_err} rel")
            m_err.append(dict(level=lvl, max_abs_err=abs_err,
                              max_rel_err=rel_err))

        # K6 against the K4 path: the same samples, channel sums in another
        # order
        d = (torch.stack(model(s8, g8, k8, mode="trajectory"), -1)
             - torch.stack(k4_model(s8, g8, k8, mode="trajectory"), -1)).abs()
    del k4_model
    vs_k4 = dict(batch=BATCH, round1_max_abs=float(d[:, 0, 0].max()),
                 final_max_abs=float(d[:, -1, -1].max()),
                 all_rounds_max_abs=float(d.max()),
                 round1_tol=PIXMOM_VS_K4_TOL[0],
                 final_tol=PIXMOM_VS_K4_TOL[1])
    if (vs_k4["round1_max_abs"] > PIXMOM_VS_K4_TOL[0]
            or vs_k4["final_max_abs"] > PIXMOM_VS_K4_TOL[1]):
        fail(f"G2SP K6 path against the K4 path: {vs_k4}")
    cpu = cpu_twin(LMG2SP, model)
    vs_cpu = traj_vs_cpu(
        torch, lambda: model(s8[:2], g8[:2], k8[:2], mode="trajectory"),
        lambda: cpu(s8[:2].cpu(), g8[:2].cpu(), k8[:2].cpu(),
                    mode="trajectory"), G2SP_ROUND1_TOL, "G2SP K6")
    row = serve_row("g2sp_pixmom_main_path", "KITTI G2SP geo LM, "
                    "g2sp_pixel_moments=1, sat 512, grd 256x1024, level 3, "
                    "N_iters 5, default K, fp32 features, bf16 map, TF32 off",
                    window, split, init_s, first_round_moments=m_err,
                    poses_vs_k4_path=vs_k4, traj_card_vs_cpu=vs_cpu)
    return row, forward


def ford_rig(torch, n):
    """The Ford data's front-left rig, camera -> body (R_FL [n, 3, 3], T_FL
    [n, 3] on the host, where the model reads its kernel layout): the
    quaternion and translation of its calibration
    (cameraFrontLeft_body.yaml)."""
    from highlyaccurate_tpu_torch.geometry.ford import qvec2rotmat
    R = qvec2rotmat(FORD_QVEC).astype(np.float32)
    T = np.asarray(FORD_T_FL, np.float32)
    return (torch.from_numpy(R).expand(n, 3, 3).contiguous(),
            torch.from_numpy(T).expand(n, 3).contiguous())


def ford_loss(model, batch, generator):
    """The Ford training forward on batch = (sat, grd, R_FL, T_FL, gt)."""
    sat, grd, R, T, gt = batch
    return model(sat, grd, FORD_SIDE_M, R, T, mode="train", gt_pose=gt,
                 generator=generator)


def phase_ford_main_path(torch, dev):
    """Ford serving at full width (``Config()``, the Ford CLI's defaults):
    ``Localizer`` with the Ford rig and a 512 x 0.22 m patch predicts a
    window of seeded batches (K1 exactly 15 times per batch, no other
    kernel); the kernel layout the rig takes and the share of samples it
    keeps in round 1, beside the JAX package's layout; the first-round
    moments of every level on the real features against the plain version;
    the trajectory of the card against a CPU run at batch 2."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.ford import (LMS2GPFord,
                                                      kernel_layout)
    from highlyaccurate_tpu_torch.ops import banded_warp as bw

    cfg = Config()
    R8, T8 = ford_rig(torch, BATCH)
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0,
                    ford_extrinsics=(R8[0].numpy(), T8[0].numpy()),
                    ford_side_m=FORD_SIDE_M)
    init_s = time.perf_counter() - t0
    sat, grd = serve_images(cfg, 4, BATCH * FORD_BATCHES)
    window = serve_window(torch, loc, sat, grd, "Ford serving",
                          {"k1": cfg.N_iters * cfg.n_levels})
    model, gen = loc.model, loc._generator
    s8, g8 = first_batch(torch, dev, sat, grd)

    def forward():
        return model(s8, g8, FORD_SIDE_M, R8, T8, mode="test", generator=gen)

    split = split_ms(torch, model, s8, g8, forward)
    with torch.no_grad():
        swap = kernel_layout(R8)
        sf, _, gf, _ = model.extract_features(s8, g8)
        pose0 = torch.zeros(BATCH, 3, device=dev)
        levels = []
        for lvl, slot in enumerate(model._slots):
            A = sf[lvl].shape[1]
            mask = getattr(model, f"mask_{slot}")
            W = mask.shape[1]
            H = gf[lvl].shape[1]
            rows = gf[lvl][:, H // 2:].contiguous()
            kept = {}
            for layout in (True, swap):   # the JAX package's, then this one
                uv01, _, _ = model._line_uv(
                    pose0, slot, A, (R8.to(dev), T8.to(dev), FORD_SIDE_M,
                                     layout))
                uvk = uv01.flip(-1) if layout else uv01
                coefs = bw.pack_row_coefs(uvk[:, :, 0], uvk[:, :, 1], A,
                                          bw.default_rb(A), W)
                kept[layout] = float(
                    (bw._line_cells(coefs, W, A)[4] * mask).mean())
            sat_k = sf[lvl].transpose(1, 2) if swap else sf[lvl]
            M, Mp = (fn(sat_k, rows, mask, uvk[:, :, 0], uvk[:, :, 1],
                        RB=bw.default_rb(A), bf16_map=True)
                     for fn in (bw.banded_moments,
                                bw.banded_moments_reference))
            abs_err, rel_err, ok = moment_error(M, Mp)
            if not ok:
                fail(f"Ford first-round moments disagree at level {lvl}: "
                     f"{abs_err} abs, {rel_err} rel")
            levels.append(dict(level=lvl, kept_share=kept[swap],
                               kept_share_jax_layout=kept[True],
                               max_abs_err=abs_err, max_rel_err=rel_err))
    if min(lv["kept_share"] for lv in levels) <= 0:
        fail(f"Ford round 1 samples nothing at some level: {levels}")
    cpu = cpu_twin(LMS2GPFord, model)
    vs_cpu = traj_vs_cpu(
        torch, lambda: model(
            s8[:2], g8[:2], FORD_SIDE_M, R8[:2], T8[:2], mode="trajectory",
            generator=torch.Generator(device=dev).manual_seed(0)),
        lambda: cpu(s8[:2].cpu(), g8[:2].cpu(), FORD_SIDE_M, R8[:2].cpu(),
                    T8[:2].cpu(), mode="trajectory",
                    generator=torch.Generator().manual_seed(0)),
        FORD_ROUND1_TOL, "Ford")
    row = serve_row("ford_main_path", "Ford LM_S2GP_Ford geo LM, sat 512 "
                    "(112.64 m), grd 256x1024, level 3, N_iters 5, Ford FL "
                    "rig, fp32 features, bf16 map, TF32 off", window, split,
                    init_s, kernel_layout_swapped=swap, first_round=levels,
                    traj_card_vs_cpu=vs_cpu)
    return row, forward


# the gather sampler path (use_banded_warp=0): card vs CPU limits on the
# round-1 pose of serving at batch 2, and on one S2GP train step at batch 2
# in the three parts of TRAIN_TOL; each limit sits between the reading and
# a known perturbation, TF32 convolutions (H100: round 1 read 1.7e-7
# / 1.2e-8 / 2.9e-7 / 2.2e-7 against 1.6e-5 / 9.7e-6 / 6.6e-5 / 1.1e-4
# with TF32; the step's loss 1.4e-7 against 3.8e-5, its gradients 1.5e-3
# over all and 2.7e-3 at worst against 0.09 and 0.13; the solver's feature
# gradients 1.3e-4, a second card run 0; see PERF.md section 6)
GATHER_BATCHES = 4     # each gather serving window
GATHER_ROUND1_TOL = {"S2GP": 3e-6, "G2SP": 1e-6, "Ford": 5e-6,
                     "G2SP32": 5e-6}
GATHER_TRAIN_TOL = {("end_to_end", "loss_rel_err"): 5e-6,
                    ("end_to_end", "grad_rel_l2_all"): 1e-2,
                    ("solver_only", "loss_rel_err"): 5e-6,
                    ("solver_only", "feature_grad_rel_l2_max"): 2e-3,
                    ("nets_only", "grad_rel_l2_max"): 2e-2,
                    ("nets_only", "grad_rel_l2_all"): 1e-2}


def gather_spec(torch, dev, family):
    """(config overrides, model class, images seed, Localizer kwargs, the
    forward's extra inputs for n images, its keyword inputs) of a family's
    serving phase, as the banded phases drive it."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import (LMS2GP,
                                                         _scaled_default_k)
    if family == "S2GP":
        return {}, LMS2GP, 0, {}, lambda n: (), True
    if family == "Ford":
        R, T = ford_rig(torch, BATCH)
        return ({}, LMS2GPFord, 4, dict(ford_extrinsics=(R[0].numpy(),
                                                         T[0].numpy()),
                                        ford_side_m=FORD_SIDE_M),
                lambda n: (FORD_SIDE_M, R[:n], T[:n]), True)
    kw = (dict(direction="G2SP") if family == "G2SP"
          else dict(direction="G2SP", grd_h=32, grd_w=128))
    k = _scaled_default_k(Config(**kw))
    k8 = torch.from_numpy(k).to(dev).expand(BATCH, 3, 3).contiguous()
    return kw, LMG2SP, 2, dict(camera_k=k), lambda n: (k8[:n],), False


def gather_family(torch, dev, family):
    """One family's serving through ``Localizer`` with ``use_banded_warp=0``
    at the flagship widths, on the weights and images of its banded phase:
    a window of ``GATHER_BATCHES`` batches that launches no hand kernel;
    the card against a CPU run of the port at batch 2; the gather poses
    against the banded path's on the same weights and inputs, for scale.
    Returns (row, forward)."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    kw, cls, seed, loc_kw, extra, reinit = gather_spec(torch, dev, family)
    cfg = Config(use_banded_warp=0, **kw)
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0,
                    **loc_kw)
    init_s = time.perf_counter() - t0
    sat, grd = serve_images(cfg, seed, BATCH * GATHER_BATCHES)
    window = serve_window(torch, loc, sat, grd, f"{family} gather serving",
                          {})
    model = loc.model
    s8, g8 = first_batch(torch, dev, sat, grd)

    def gen(device):
        return (dict(generator=torch.Generator(device=device).manual_seed(0))
                if reinit else {})

    def forward():
        return model(s8, g8, *extra(BATCH), mode="test",
                     **(dict(generator=loc._generator) if reinit else {}))

    def traj(m, n, device):
        args = [a.to(device) if torch.is_tensor(a) and family != "Ford"
                else a for a in extra(n)]
        if family == "Ford":   # the rig stays on the host
            args = [args[0]] + [a.cpu() for a in args[1:]]
        return m(s8[:n].to(device), g8[:n].to(device), *args,
                 mode="trajectory", **gen(device))

    split = split_ms(torch, model, s8, g8, forward)
    cpu = cpu_twin(cls, model)
    vs_cpu = traj_vs_cpu(torch, lambda: traj(model, 2, dev),
                         lambda: traj(cpu, 2, "cpu"),
                         GATHER_ROUND1_TOL[family], f"{family} gather")
    del cpu
    banded = cls(Config(**kw), device=dev)
    banded.load_state_dict(model.state_dict())
    reset_launches()
    with torch.no_grad():
        d = (torch.stack(traj(model, BATCH, dev), -1)
             - torch.stack(traj(banded, BATCH, dev), -1)).abs()
    del banded
    row = serve_row(
        "gather_main_path", f"{family} geo LM, use_banded_warp=0 (the gather "
        f"sampler), sat {cfg.sat_size}, grd {cfg.grd_h}x{cfg.grd_w}, level "
        f"{cfg.level}, N_iters {cfg.N_iters}, fp32 features, TF32 off",
        window, split, init_s,
        family=family, traj_card_vs_cpu=vs_cpu, poses_vs_banded=dict(
            batch=BATCH, round1_max_abs=float(d[:, 0, 0].max()),
            final_max_abs=float(d[:, -1, -1].max())))
    return row, forward


def phase_gather_main_path(torch, dev, gpu):
    """The gather sampler path on the card: S2GP, G2SP and Ford serving
    (``gather_family``, each with a profile of one forward), one S2GP train
    step through the gather path against a CPU run at batch 2, and G2SP at
    a 32-row ground input, whose coarse level takes the gather sampler and
    the other two the projective-line kernels (exactly 10 K4 launches per
    batch and no other kernel), against a CPU run at batch 2.  Prints the
    phase's seconds."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    from highlyaccurate_tpu_torch.params import init_params
    t_phase = time.perf_counter()
    for family in ("S2GP", "G2SP", "Ford"):
        row, forward = gather_family(torch, dev, family)
        eval_profile(torch, f"profile_gather_{family.lower()}", forward,
                     row["forward_ms_per_batch"],
                     f"chiprun_out/profile_gather_{family.lower()}_eval_b8"
                     ".txt", {})
        del forward
        torch.cuda.empty_cache()

    # one S2GP train step through the gather path, card against CPU
    cfg = Config(use_banded_warp=0)
    model = LMS2GP(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    rng = np.random.RandomState(1)
    b = TRAIN_CHECK_BATCH
    batch = tuple(torch.from_numpy(a).to(dev) for a in (
        (rng.rand(b, cfg.sat_size, cfg.sat_size, 3) * 255).astype(
            np.uint8).astype(np.float32) / 255.0,
        (rng.rand(b, cfg.grd_h, cfg.grd_w, 3) * 255).astype(
            np.uint8).astype(np.float32) / 255.0,
        rng.uniform(-1, 1, (b, 3)).astype(np.float32)))
    reset_launches()
    check = card_vs_cpu(torch, LMS2GP, cfg, weights, batch, dev, s2gp_loss,
                        contextlib.nullcontext)
    expect_launches("gather train step", {})
    emit(dict(phase="gather_train_card_vs_cpu", batch=b, **check, limits={
        f"{part}.{key}": tol for (part, key), tol in
        GATHER_TRAIN_TOL.items()}))
    check_limits("gather train step", check, GATHER_TRAIN_TOL)
    torch.cuda.empty_cache()

    # G2SP at a 32-row ground input: the per-slot mixed choice
    from highlyaccurate_tpu_torch.inference import Localizer
    kw, cls, seed, loc_kw, extra, _ = gather_spec(torch, dev, "G2SP32")
    cfg = Config(**kw)
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0,
                    **loc_kw)
    if loc.model._projline != {0: False, 1: True, 2: True}:
        fail(f"G2SP 32-row: slot samplers {loc.model._projline}")
    sat, grd = serve_images(cfg, seed, BATCH * 2)
    out, wall, counts, _ = serve_window(
        torch, loc, sat, grd, "G2SP 32-row serving",
        {"k4": cfg.N_iters * 2})
    s8, g8 = first_batch(torch, dev, sat, grd)
    cpu = cpu_twin(cls, loc.model)
    k2 = extra(2)[0]
    vs_cpu = traj_vs_cpu(
        torch, lambda: loc.model(s8[:2], g8[:2], k2, mode="trajectory"),
        lambda: cpu(s8[:2].cpu(), g8[:2].cpu(), k2.cpu(), mode="trajectory"),
        GATHER_ROUND1_TOL["G2SP32"], "G2SP 32-row")
    emit(dict(phase="gather_g2sp_32row", gpu=gpu,
              config=f"KITTI G2SP geo LM, sat {cfg.sat_size}, grd "
                     f"{cfg.grd_h}x{cfg.grd_w} (slot 0 on the gather "
                     "sampler, slots 1-2 on K4), level 3, N_iters "
                     f"{cfg.N_iters}, fp32 features, bf16 map, TF32 off",
              batch=BATCH, images=out["lateral_m"].shape[0], wall_s=wall,
              k4_launches=counts["k4"],
              k4_launches_per_batch=counts["k4"] // 2,
              traj_card_vs_cpu=vs_cpu,
              lateral_m_first=out["lateral_m"][:4].tolist()))
    emit(dict(phase="gather_main_path_total",
              seconds=time.perf_counter() - t_phase))


CLI_ROOT = "build/cli_smoke"
# the flagship defaults of each CLI (sat 512, grd 256x1024, level 3,
# N_iters 5), 2 epochs of synthetic data at batch 8
CLI_RUNS = {"S2GP": ["--synthetic", "16", "--batch_size", "8"],
            "G2SP": ["--direction", "G2SP", "--synthetic", "8",
                     "--batch_size", "8"],
            "Ford": ["--synthetic", "16", "--batch_size", "8"]}
CLI_PER_CALL = {("S2GP", "train"): {"k2": 15, "k3": 15},
                ("S2GP", "eval"): {"k1": 15},
                ("G2SP", "train"): {"k4": 15, "k5": 15},
                ("G2SP", "eval"): {"k4": 15},
                ("Ford", "train"): {"k2": 15, "k3": 15},
                ("Ford", "eval"): {"k1": 15}}
# bf16 features against the float32 reload of the same weights: the
# largest |pose difference| over the evaluated splits (m, deg).  Each limit
# lies between the readings and a known perturbation, the effect of
# epoch 1's two Adam steps at lr 1e-4 (float32 evaluations of model_0
# against model_1, printed beside it).  H100, random weights: with cuDNN's
# deterministic algorithms three runs read S2GP 0.166 m / 0.251 deg
# against 1.170 / 0.542 and G2SP 0.011 / 0.018 against 0.165 / 0.282, bit
# for bit alike; with its default algorithms (other weights in every run)
# three runs read up to 0.466 / 0.459 against at least 1.003 / 0.561, and
# up to 0.085 / 0.094 against at least 0.161 / 0.287.  The 15 LM rounds
# of random weights amplify any change of the features.  Ford,
# deterministic cuDNN, two runs in fresh processes: 0.254 m / 0.340 deg
# both, against 1.612 / 0.886.
CLI_BF16_LIMIT = {"S2GP": (0.7, 0.5), "G2SP": (0.12, 0.17),
                  "Ford": (0.8, 0.6)}


def cli_phase(family):
    return "cli_ford" if family == "Ford" else "cli_kitti"


def cli_module(family):
    """The CLI module of ``family``: the Ford CLI or the KITTI one."""
    if family == "Ford":
        from highlyaccurate_tpu_torch.cli import train_ford
        return train_ford
    from highlyaccurate_tpu_torch.cli import train_kitti
    return train_kitti


def cli_save_path(family, cfg, root):
    return (cfg.save_path_ford(root) if family == "Ford"
            else cfg.save_path(root))


@contextlib.contextmanager
def counted_steps(torch, family, log, per_call=None):
    """The CLI's train and eval steps, each call checked to launch
    exactly ``per_call[kind]``'s kernels (default ``CLI_PER_CALL``'s) and
    timed on the host clock between two ``torch.cuda.synchronize()``
    (``log[kind]`` gets the seconds)."""
    from highlyaccurate_tpu_torch.train import step as step_lib
    makers = {"train": step_lib.make_train_step,
              "eval": step_lib.make_eval_step}

    def wrap(kind):
        def make(*a, **kw):
            step = makers[kind](*a, **kw)

            def counted(*args):
                before = {k: fn.launches for k, fn in _counters().items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                log[kind].append(time.perf_counter() - t0)
                got = {k: fn.launches - before[k]
                       for k, fn in _counters().items()}
                per = (per_call[kind] if per_call is not None
                       else CLI_PER_CALL[family, kind])
                want = {k: per.get(k, 0) for k in got}
                if got != want:
                    fail(f"{cli_phase(family)} {family} {kind} step "
                         f"launched {got}, expected {want}")
                return out
            return counted
        return make

    step_lib.make_train_step = wrap("train")
    step_lib.make_eval_step = wrap("eval")
    try:
        yield
    finally:
        step_lib.make_train_step = makers["train"]
        step_lib.make_eval_step = makers["eval"]


def cli_results(family, save_path):
    """The predictions of the last evaluation of each split ([N, 3]: lat m,
    lon m, heading deg) and every ``Time per image`` of its results file:
    KITTI's test1 and test2, Ford's test log 0."""
    import scipy.io
    files = ({"log0": ("0_result.mat", "0_results.txt")} if family == "Ford"
             else {s: (f"{s}_results.mat", f"{s}_results.txt")
                   for s in ("Test1", "Test2")})
    out = {}
    for split, (mat, txt) in files.items():
        m = scipy.io.loadmat(os.path.join(save_path, mat))
        preds = np.concatenate([m["pred_shifts"], m["pred_headings"]], 1)
        with open(os.path.join(save_path, txt)) as f:
            tpi = [float(ln.split(":")[1]) for ln in f
                   if ln.startswith("Time per image")]
        out[split] = (preds, tpi)
    return out


def cli_run(torch, family, argv, expected, per_call=None):
    """The family's CLI ``main(argv)`` in this process with the launch
    counts set to 0 just before and read just after (each kernel of
    ``expected`` exactly that often, no other; each step as
    ``counted_steps`` checks it); the CLI's own printing goes to
    chiprun_out/<phase>.log.  Returns the step logs, the counts and the
    seconds."""
    log = {"train": [], "eval": []}
    phase = cli_phase(family)
    os.makedirs("chiprun_out", exist_ok=True)
    with counted_steps(torch, family, log, per_call), \
            open(f"chiprun_out/{phase}.log", "a") as out, \
            contextlib.redirect_stdout(out):
        print(f"=== {family}: {' '.join(argv)}", flush=True)
        reset_launches()
        t0 = time.perf_counter()
        cli_module(family).main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = expect_launches(f"{phase} {family} {argv[:2]}", expected)
    return log, counts, seconds


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms: a training run then gives the
    same weights in every run, so the bf16 readings repeat (with the
    default algorithms cuDNN's backward is not bit-deterministic, and the
    weights, and with them the readings, differ from run to run)."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def phase_cli_kitti(torch, gpu):
    """The KITTI CLI at the flagship defaults, for S2GP and G2SP
    (``cli_family``)."""
    import shutil
    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    with deterministic_cudnn(torch):
        return {family: cli_family(torch, gpu, family)
                for family in ("S2GP", "G2SP")}


def phase_cli_ford(torch, gpu):
    """The Ford CLI at the flagship defaults (``cli_family``), on
    ``SyntheticFord``'s Ford rig, then one ``--transformer 1`` epoch."""
    with deterministic_cudnn(torch):
        return cli_family(torch, gpu, "Ford")


def cli_family(torch, gpu, family):
    """A CLI at the flagship defaults for one family: train 2 epochs on
    synthetic data (fp32, TF32 off, cuDNN deterministic), then ``--test
    1`` on copies of its experiment directory: with ``--compute_dtype
    float32``, whose predictions must equal the in-training evaluation of
    epoch 1 bit for bit (the checkpoint round trip at full width), with
    bf16 features (the default), within ``CLI_BF16_LIMIT`` of those, and
    with epoch 0's weights, the effect of two Adam steps, printed beside
    it for scale.  KITTI reloads ``model_1`` and evaluates test1 and
    test2; Ford reloads ``Model_best`` (a copy of epoch 1's weights) and
    evaluates its test log, then trains one ``--transformer 1`` epoch from
    a ``Model_best`` in the base experiment, whose two feature networks
    must stay bit-equal.  Returns its row."""
    import shutil

    run = CLI_RUNS[family]
    phase = cli_phase(family)
    ford = family == "Ford"
    root = os.path.join(CLI_ROOT, family)
    shutil.rmtree(root, ignore_errors=True)
    train_argv = ["--test", "0", "--epochs", "2", "--save_root",
                  root] + run
    mod = cli_module(family)
    from highlyaccurate_tpu_torch.config import config_from_args
    args = mod.parse_args(train_argv)
    cfg = config_from_args(args)
    steps = args.synthetic // cfg.batch_size          # per epoch
    batches = 1 + -(-args.synthetic // cfg.batch_size)  # + warm-up
    splits = 1 if ford else 2
    per = CLI_PER_CALL

    def launches(n_train, n_eval):
        out = {k: v * n_train for k, v in per[family, "train"].items()}
        for k, v in per[family, "eval"].items():
            out[k] = out.get(k, 0) + v * n_eval
        return out

    log, counts, train_s = cli_run(torch, family, train_argv,
                                   launches(2 * steps, 2 * splits * batches))
    save_path = cli_save_path(family, cfg, root)
    trained = cli_results(family, save_path)
    for name in ("model_0.pth", "model_1.pth"):
        if not os.path.isfile(os.path.join(save_path, name)):
            fail(f"{phase} {family}: no {name}")
    for split, (preds, tpi) in trained.items():
        if len(tpi) != 2 or not np.isfinite(preds).all():
            fail(f"{phase} {family} {split}: {len(tpi)} result blocks,"
                 f" finite predictions {np.isfinite(preds).all()}")
    reload_name = "Model_best.pth" if ford else "model_1.pth"

    def reload(tag, argv, weights="model_1.pth"):
        troot = os.path.join(CLI_ROOT, f"{family}_{tag}")
        shutil.rmtree(troot, ignore_errors=True)
        tpath = cli_save_path(family, cfg, troot)
        os.makedirs(tpath)
        shutil.copy(os.path.join(save_path, weights),
                    os.path.join(tpath, reload_name))
        _, _, secs = cli_run(
            torch, family, ["--test", "1", "--save_root", troot] + run
            + argv, launches(0, splits * batches))
        return cli_results(family, tpath), secs

    fp32, fp32_s = reload("fp32", ["--compute_dtype", "float32"])
    bf16, bf16_s = reload("bf16", [])
    epoch0, _ = reload("epoch0", ["--compute_dtype", "float32"],
                       "model_0.pth")
    bitwise = all(np.array_equal(fp32[k][0], trained[k][0])
                  for k in trained)

    def worst(res):
        d = np.concatenate([np.abs(res[k][0] - fp32[k][0])
                            for k in fp32])
        return [float(d[:, :2].max()), float(d[:, 2].max())]

    train_log = log["train"]
    row = dict(
        phase=phase, family=family, gpu=gpu,
        config=f"{'Ford' if ford else 'KITTI ' + family} CLI, sat "
               f"{cfg.sat_size}, grd {cfg.grd_h}x{cfg.grd_w}, level "
               f"{cfg.level}, N_iters {cfg.N_iters}, batch "
               f"{cfg.batch_size}, synthetic {args.synthetic}, 2 epochs, "
               f"fp32 training, TF32 off, cuDNN deterministic",
        train_steps=len(train_log), eval_batches=len(log["eval"]),
        launches=counts,
        train_images_per_s_without_step0=(
            cfg.batch_size * (len(train_log) - 1) / sum(train_log[1:])),
        train_step_s=train_log,
        eval_time_per_image_s={k: v[1] for k, v in trained.items()},
        reload_fp32_time_per_image_s={k: v[1] for k, v in fp32.items()},
        reload_bf16_time_per_image_s={k: v[1] for k, v in bf16.items()},
        run_s=train_s, reload_fp32_s=fp32_s, reload_bf16_s=bf16_s,
        reload_fp32_bitwise_equal=bitwise,
        bf16_vs_fp32_max_m_deg=worst(bf16),
        epoch0_vs_epoch1_max_m_deg=worst(epoch0),
        bf16_limit_m_deg=CLI_BF16_LIMIT[family])
    if ford:
        row.update(cli_ford_transformer(torch, family, cfg, save_path, root,
                                        run, steps, launches(
                                            steps, splits * batches)))
    emit(row)
    if not bitwise:
        fail(f"{phase} {family}: the float32 reload does not equal epoch "
             "1's evaluation bit for bit")
    lim = CLI_BF16_LIMIT[family]
    got = row["bf16_vs_fp32_max_m_deg"]
    if not (np.isfinite(got).all()
            and all(g <= t for g, t in zip(got, lim))):
        fail(f"{phase} {family}: bf16 evaluation {got} m/deg from the "
             f"float32 one, limit {lim}")
    if ford and not row["transformer_backbones_bitwise_equal"]:
        fail("cli_ford: --transformer 1 changed the frozen backbones")
    return row


def cli_ford_transformer(torch, family, cfg, base_path, root, run, steps,
                         expected):
    """One ``--transformer 1`` epoch of the Ford CLI: ``Model_best`` in the
    base experiment (its restore path; a copy of epoch 1's weights, since
    random data may never raise the rank) seeds the model, and both
    feature networks must come out of the epoch bit-equal.  Returns the
    row's entries."""
    import shutil
    best = os.path.join(base_path, "Model_best.pth")
    shutil.copy(os.path.join(base_path, "model_1.pth"), best)
    argv = ["--test", "0", "--epochs", "1", "--transformer", "1",
            "--save_root", root] + run
    from highlyaccurate_tpu_torch.config import config_from_args
    restore, tpath = config_from_args(
        cli_module(family).parse_args(argv)).ford_paths(root)
    if os.path.normpath(restore) != os.path.normpath(base_path):
        fail(f"cli_ford: --transformer restores from {restore}, not "
             f"{base_path}")
    log, _, secs = cli_run(torch, family, argv, expected)
    want = torch.load(best, map_location="cpu", weights_only=True)
    got = torch.load(os.path.join(tpath, "model_0.pth"), map_location="cpu",
                     weights_only=True)
    frozen = [k for k in want
              if k.startswith(("SatFeatureNet.", "GrdFeatureNet."))]
    return dict(transformer_train_steps=len(log["train"]),
                transformer_run_s=secs,
                transformer_backbones_bitwise_equal=bool(
                    frozen and len(log["train"]) == steps
                    and all(torch.equal(got[k], want[k]) for k in frozen)))


# the rest of the serving API (serving_api): limits of the card against
# the CPU twin, each between the reading and a known perturbation, TF32
# convolutions (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5): the
# covariance at one pose, relative Frobenius per image (read 1.1e-7 /
# 4.2e-7 / 2.8e-7 for S2GP / G2SP / Ford against 1.4e-4 / 5.3e-5 /
# 1.6e-4 with TF32), and the
# multi-start winning pose after 15 rounds, normalized (read 1.5e-4 /
# 4.2e-7 against 6.1e-4 / 9.5e-5).  The same image at batch 1 and at
# batch 8 on the live model, the same re-init numbers at both sizes
# (serving_cross_batch), normalized, (round 1, final pose): the two sizes
# run other convolution algorithms (cuDNN's; oneDNN's on the CPU), whose
# last bits round 1 shows (read 2.9e-7 / 1.9e-9 for S2GP / G2SP, the CPU
# 9.0e-8, against 1.8e-4 / 3.0e-5 with TF32) and 15 rounds on random
# weights amplify on a few images (final read 1.6e-2 / 5.0e-6, the CPU
# 8.6e-3, against TF32's 7.2e-3 / 1.7e-4; no re-init fired): round 1
# between the readings and TF32's, the final pose 3-10x above its reading
SERVING_COV_TOL = 1e-5
SERVING_MULTI_TOL = {"S2GP": 4e-4, "G2SP": 1e-5}
SERVING_CROSS_TOL = {"S2GP": (1e-5, 5e-2), "G2SP": (1e-5, 5e-5)}
SERVING_P = 4          # multi-start hypotheses at batch 2: B x P = 8
SERVING_MS_IMAGES = 16  # the multi-start window, 8 batches of 2
SERVING_ROOT = "build/serving_api"
# the batch sizes each family exports: one program each (a trace is ~2
# minutes of host work per program; [1, 8] for both took 283 s of one
# earlier run on the H100): S2GP's batch-1 program (the one-frame latency)
# and G2SP's batch-8 one, each held bit for bit to a live Localizer of its
# batch size
SERVING_EXPORT_SIZES = {"S2GP": [1], "G2SP": [BATCH]}
# run by phase_serving_api in a process of its own per family, from the
# repository root, the two at once: the family's Localizer
# (the weights of seed 0, as the live one's) exported with its
# SERVING_EXPORT_SIZES; prints the trace's seconds and a checksum of the
# weights
EXPORT_CHILD = """
import json, sys, time, torch
import chip_smoke as cs
from highlyaccurate_tpu_torch.inference import Localizer
family = sys.argv[1]
cfg, _, kw, _, _ = cs.serving_family(torch, torch.device("cuda", 0), family)
loc = Localizer(cfg, random_init=True, batch_size=cs.BATCH, seed=0, **kw)
t0 = time.perf_counter()
loc.export(cs.SERVING_ROOT + "/" + family + ".zip",
           batch_sizes=cs.SERVING_EXPORT_SIZES[family])
print(json.dumps(dict(export_s=time.perf_counter() - t0,
                      weights=cs.weights_sum(loc.model))), flush=True)
"""
# run after them in a fresh process: each exported artifact served by
# ExportedLocalizer on the images the live Localizer predicted; prints
# one JSON line per family
EXPORTED_CHILD = """
import json, sys, time
import numpy as np, torch
import chip_smoke as cs
from highlyaccurate_tpu_torch.inference import ExportedLocalizer
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
for family in sys.argv[1:]:
    root = cs.SERVING_ROOT + "/" + family
    t0 = time.perf_counter()
    srv = ExportedLocalizer(root + ".zip", seed=0)
    load_s = time.perf_counter() - t0
    d = np.load(root + "_in.npz")
    cs.reset_launches()
    out = srv.predict(d["sat"], d["grd"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in cs._counters().items()}
    np.savez(root + "_out.npz", **out)
    ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        srv.predict(d["sat"][:1], d["grd"][:1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(dict(family=family, load_s=load_s, launches=launches,
                          one_image_ms=float(np.median(ms[1:])))),
          flush=True)
"""


def serving_family(torch, dev, family, **over):
    """(Config, model class, Localizer kwargs, the forward's extra inputs
    of n images on ``device``, the launch key of its solver kernel) of a
    serving family at the flagship widths."""
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import (LMS2GP,
                                                         _scaled_default_k)
    if family == "G2SP":
        cfg = Config(direction="G2SP", **over)
        k = _scaled_default_k(cfg)
        return (cfg, LMG2SP, dict(camera_k=k), lambda n, d: (
            torch.from_numpy(k).to(d).expand(n, 3, 3).contiguous(),), "k4")
    cfg = Config(**over)
    if family == "Ford":
        R, T = ford_rig(torch, BATCH)
        # the rig stays on the host, where the model reads its layout
        return (cfg, LMS2GPFord, dict(ford_extrinsics=(R[0].numpy(),
                                                       T[0].numpy()),
                                      ford_side_m=FORD_SIDE_M),
                lambda n, d: (FORD_SIDE_M, R[:n], T[:n]), "k1")
    return cfg, LMS2GP, {}, lambda n, d: (), "k1"


def rel_fro(got, want):
    """The largest relative Frobenius error over [N, 3, 3] matrices."""
    return float(max(np.linalg.norm(g - w) / np.linalg.norm(w)
                     for g, w in zip(got, want)))


def pose_info(torch, family, model, sat, grd, extra, pose):
    """The normalized covariance [B, 3, 3] of ``model`` at ``pose``."""
    with torch.no_grad():
        sf, _, gf, _ = model.extract_features(sat, grd)
        if family == "G2SP":
            return model._pose_info(sf, gf, pose, extra[0]).cpu().numpy()
        geo = (model._geo(extra[1], extra[2], extra[0]),) \
            if family == "Ford" else ()
        return model._pose_info(sf, gf, pose, *geo).cpu().numpy()


def serving_cov(torch, dev, family):
    """``predict(return_cov=True)`` at batch 8 (two batches, exactly 15
    launches of the family's solver kernel per batch, no other kernel):
    the metric covariance finite, symmetric, positive definite on the
    active DoFs and zero on the frozen ones; then the covariance at one
    pose on the card against the CPU twin at batch 2, beside the card with
    TF32 convolutions.  Returns (row, the Localizer)."""
    from highlyaccurate_tpu_torch.inference import Localizer
    cfg, cls, kw, extra, key = serving_family(torch, dev, family)
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0, **kw)
    sat, grd = serve_images(cfg, 6, 2 * BATCH)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loc.predict(sat[:BATCH], grd[:BATCH], return_cov=True)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = loc.predict(sat, grd, return_cov=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not any("UNCALIBRATED" in str(w.message) for w in caught):
        fail(f"{family} return_cov: no uncalibrated warning")
    counts = expect_launches(f"{family} return_cov",
                             {key: 2 * cfg.N_iters * cfg.n_levels})
    cov = out["cov"].astype(np.float64)
    act = list(cfg.active_pose_dims)
    frozen = [i for i in range(3) if i not in act]
    eig = np.linalg.eigvalsh(cov[:, act][:, :, act])
    asym = float(np.abs(cov - cov.transpose(0, 2, 1)).max()
                 / np.abs(cov).max())
    if (cov.shape != (2 * BATCH, 3, 3) or not np.isfinite(cov).all()
            or asym > 1e-6 or eig.min() <= 0
            or (cov[:, frozen] != 0).any()):
        fail(f"{family} return_cov: shape {cov.shape}, asymmetry {asym}, "
             f"least eigenvalue {eig.min()}")
    model = loc.model
    s2, g2 = (t[:2] for t in first_batch(torch, dev, sat, grd))
    pose = torch.from_numpy(np.random.RandomState(7).uniform(
        -0.3, 0.3, (2, 3)).astype(np.float32))
    t0 = time.perf_counter()
    cpu = cpu_twin(cls, model)
    want = pose_info(torch, family, cpu, s2.cpu(), g2.cpu(),
                     extra(2, "cpu"), pose)
    cpu_s = time.perf_counter() - t0
    del cpu
    got = pose_info(torch, family, model, s2, g2, extra(2, dev),
                    pose.to(dev))
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = pose_info(torch, family, model, s2, g2, extra(2, dev),
                         pose.to(dev))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    vs_cpu = dict(batch=2, cov_rel_fro=rel_fro(got, want),
                  cov_rel_fro_tf32_convs=rel_fro(tf32, want),
                  tol=SERVING_COV_TOL, cpu_s=cpu_s)
    if not vs_cpu["cov_rel_fro"] <= SERVING_COV_TOL:
        fail(f"{family} covariance, card vs CPU: {vs_cpu}")
    return dict(family=family, images=2 * BATCH, wall_s=wall,
                ms_per_batch=wall / 2 * 1e3, launches=counts,
                cov_sd_first=np.sqrt(np.diagonal(cov[0])).tolist(),
                least_eigenvalue=float(eig.min()), asymmetry=asym,
                frozen_dofs=frozen, cov_card_vs_cpu=vs_cpu), loc


def serving_multi_start(torch, dev, family):
    """``pose_hypotheses = SERVING_P`` at batch 2: the same draws (the
    starts, then every round's re-init numbers) to the card and to the CPU
    twin through ``hypotheses``; the winner index equal on both and the
    winning pose within ``SERVING_MULTI_TOL`` (normalized), beside the
    card with TF32 convolutions; then a window of ``Localizer.predict``
    whose solver kernel launches 15 times per batch, each at batch
    B x P = 8, and no other kernel."""
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_s2gp import eval_draws_per_image
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    from highlyaccurate_tpu_torch.ops import projline as tpl
    from highlyaccurate_tpu_torch.solver.updates import PresetDraws
    cfg, cls, kw, extra, key = serving_family(torch, dev, family,
                                              pose_hypotheses=SERVING_P)
    loc = Localizer(cfg, random_init=True, batch_size=2, seed=0, **kw)
    model = loc.model
    sat, grd = serve_images(cfg, 8, SERVING_MS_IMAGES)
    s2, g2 = (t[:2] for t in first_batch(torch, dev, sat, grd))
    n = 2 * eval_draws_per_image(cfg, model.lm_cfg)
    draws = torch.from_numpy(np.random.RandomState(9).uniform(
        -1.0, 1.0, n).astype(np.float32))

    def sweep(m, device):
        args = extra(2, device)
        with torch.no_grad():
            sf, _, gf, _ = m.extract_features(s2.to(device), g2.to(device))
            gen = PresetDraws(draws.to(device))
            if family == "G2SP":
                final, cost = m.hypotheses(sf, gf, args[0], None, gen)
            else:
                final, cost = m.hypotheses(sf, gf, None, gen)
        best = cost.argmin(1)
        return (final[torch.arange(2, device=final.device), best].cpu()
                .numpy(), best.cpu().numpy(), cost.cpu().numpy())

    t0 = time.perf_counter()
    cpu = cpu_twin(cls, model)
    want, want_best, want_cost = sweep(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    del cpu
    got, got_best, got_cost = sweep(model, dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32, tf32_best, _ = sweep(model, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    gap = np.sort(want_cost, 1)
    vs_cpu = dict(batch=2, hypotheses=SERVING_P,
                  winner_card=got_best.tolist(),
                  winner_cpu=want_best.tolist(),
                  winner_tf32_convs=tf32_best.tolist(),
                  cost_gap_cpu=(gap[:, 1] - gap[:, 0]).tolist(),
                  pose_max_abs=float(np.abs(got - want).max()),
                  pose_max_abs_tf32_convs=float(np.abs(tf32 - want).max()),
                  tol=SERVING_MULTI_TOL[family], cpu_s=cpu_s)
    if (got_best != want_best).any() or \
            not vs_cpu["pose_max_abs"] <= SERVING_MULTI_TOL[family]:
        fail(f"{family} multi-start, card vs CPU: {vs_cpu}")
    # the window: every launch of the solver kernel at batch B x P
    batches = []
    op_name = "_banded_moments_op" if key == "k1" else "_projline_sample_op"
    mod = bw if key == "k1" else tpl
    op = getattr(mod, op_name)

    def seen(t, *a):
        batches.append(t.shape[0])
        return op(t, *a)

    loc.predict(sat[:2], grd[:2])   # warm-up
    torch.cuda.synchronize()
    setattr(mod, op_name, seen)
    try:
        reset_launches()
        t0 = time.perf_counter()
        loc.predict(sat, grd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(mod, op_name, op)
    n_batches = SERVING_MS_IMAGES // 2
    counts = expect_launches(f"{family} multi-start",
                             {key: n_batches * cfg.N_iters * cfg.n_levels})
    if set(batches) != {2 * SERVING_P}:
        fail(f"{family} multi-start launched at batches {set(batches)}")
    return dict(family=family, hypotheses=SERVING_P, batch=2,
                kernel_batch=2 * SERVING_P, images=SERVING_MS_IMAGES,
                wall_s=wall, frames_per_s=SERVING_MS_IMAGES / wall,
                ms_per_batch=wall / n_batches * 1e3, launches=counts,
                card_vs_cpu=vs_cpu)


def serving_calibrate(torch, loc):
    """``calibrate`` on two synthetic batches of 8 with ground-truth
    poses: a finite positive scale; ``predict(return_cov=True)`` then
    warns no more."""
    cfg = loc.cfg
    rng = np.random.RandomState(10)
    batches = []
    for b in range(2):
        sat, grd = serve_images(cfg, 11 + b, BATCH)
        gt = np.stack([rng.uniform(-5, 5, BATCH), rng.uniform(-5, 5, BATCH),
                       rng.uniform(-3, 3, BATCH)], -1).astype(np.float32)
        batches.append(dict(sat=sat, grd=grd, gt_pose=gt))
    t0 = time.perf_counter()
    scale = loc.calibrate(batches)
    secs = time.perf_counter() - t0
    if not (np.isfinite(scale) and scale > 0):
        fail(f"calibrate: scale {scale}")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = loc.predict(batches[0]["sat"], batches[0]["grd"],
                          return_cov=True)
    if not np.isfinite(out["cov"]).all():
        fail("calibrate: non-finite covariance after the fit")
    return dict(batches=2, batch=BATCH, cov_scale=scale, seconds=secs)


def weights_sum(model) -> float:
    """A checksum of a model's weights and buffers."""
    return float(sum(t.double().sum() for t in model.state_dict().values()))


def start_exports(families):
    """One ``EXPORT_CHILD`` process per family, started at once (the
    traces are host work); output under ``SERVING_ROOT``."""
    os.makedirs(SERVING_ROOT, exist_ok=True)
    procs = {}
    for family in families:
        with open(f"{SERVING_ROOT}/{family}_export.log", "w") as log:
            procs[family] = subprocess.Popen(
                [sys.executable, "-c", EXPORT_CHILD, family],
                stdout=subprocess.PIPE, stderr=log, text=True)
    return procs


def serving_cross_batch(torch, dev, family, cpu_too):
    """The same image at batch 1 and at batch 8 through the live model of
    the exported weights (``Localizer(seed=0)``): the 9 images of
    ``serving_export`` as 9 batches of 1 and as a batch of 8 and a tail of
    1 padded to 8 (as ``predict`` pads it), each image given the same
    re-init numbers at both sizes (``PresetDraws``).  The round-1 pose
    (``mode="trajectory"``; each round's is reported) within the family's
    ``SERVING_CROSS_TOL[0]`` (also on the CPU twin) and the final one
    (``mode="test"``, what ``predict`` returns) within its
    ``SERVING_CROSS_TOL[1]``, normalized; beside them the batch of 8 with
    TF32 convolutions (a known perturbation for scale), the final pose of
    the batch of 8 with other re-init numbers (the images whose answer
    depends on the draws, which a Localizer draws per batch from its
    generator) and, with ``cpu_too``, the same comparison on the CPU twin.
    """
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_s2gp import eval_draws_per_image
    from highlyaccurate_tpu_torch.solver.updates import PresetDraws
    cfg, cls, kw, extra, _ = serving_family(torch, dev, family)
    t0 = time.perf_counter()
    locs = {bs: Localizer(cfg, random_init=True, batch_size=bs, seed=0,
                          device=dev, **kw) for bs in (1, BATCH)}
    model = locs[BATCH].model
    sat, grd = serve_images(cfg, 12, BATCH + 1)
    n = BATCH + 1
    # as served: two Localizers of seed 0, each drawing its re-init
    # numbers per batch from its own generator
    scale = np.array([cfg.shift_range_lat, cfg.shift_range_lon,
                      cfg.rotation_range])
    pred = {bs: np.stack([loc.predict(sat, grd)[k] for k in (
        "lateral_m", "longitudinal_m", "heading_deg")], -1) / scale
        for bs, loc in locs.items()}
    del locs[1]
    per_image = eval_draws_per_image(cfg, model.lm_cfg) // 2  # rounds
    rng = np.random.RandomState(13)
    bases = [rng.uniform(-1.0, 1.0, (per_image, 2, n)).astype(np.float32)
             for _ in range(2)]

    def run(m, device, idx, mode, base=0):
        s, g = (torch.from_numpy(a[idx].astype(np.float32) / 255.0)
                .to(device) for a in (sat, grd))
        gen = ({} if family == "G2SP" else dict(generator=PresetDraws(
            torch.from_numpy(bases[base][:, :, idx].reshape(-1))
            .to(device))))
        with torch.no_grad():
            out = m(s, g, *extra(len(idx), device), mode=mode, **gen)
        if mode == "trajectory":   # [B, rounds, 3], iteration-major
            return torch.stack([t.flatten(1) for t in out], -1).cpu().numpy()
        return torch.stack(list(out), -1).cpu().numpy()

    def sizes(m, device, mode, base=0):
        """(batch 8 with the padded tail, batches of 1) [9, 3] each."""
        eight = np.concatenate([run(m, device, list(range(BATCH)), mode,
                                    base),
                                run(m, device, [BATCH] * BATCH, mode,
                                    base)[:1]])
        one = np.concatenate([run(m, device, [i], mode, base)
                              for i in range(n)])
        return eight, one

    def compare(m, device):
        (r8, r1), (f8, f1) = (sizes(m, device, mode)
                              for mode in ("trajectory", "test"))
        per_round = np.abs(r8 - r1).max((0, 2))
        return dict(round1_max_abs=float(per_round[0]),
                    final_max_abs=float(np.abs(f8 - f1).max()),
                    final_abs_per_image=np.abs(f8 - f1).max(1).tolist(),
                    max_abs_per_round=per_round.tolist()), f8

    card, f8 = compare(model, dev)
    other = sizes(model, dev, "test", base=1)[0]
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = sizes(model, dev, "test")[0]
        tf32_r1 = sizes(model, dev, "trajectory")[0]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    r8 = sizes(model, dev, "trajectory")[0]
    tol = SERVING_CROSS_TOL[family]
    row = dict(family=family, images=n, card=card, tol=tol,
               round1_max_abs_tf32_convs=float(
                   np.abs(tf32_r1 - r8)[:, 0].max()),
               final_max_abs_tf32_convs=float(np.abs(tf32 - f8).max()),
               draw_dependent_images=[
                   i for i in range(n) if (other[i] != f8[i]).any()],
               final_max_abs_other_draws=float(np.abs(other - f8).max()),
               predict_max_abs_per_image=np.abs(pred[1] - pred[BATCH])
               .max(1).tolist(), card_s=time.perf_counter() - t0)
    if cpu_too:
        t0 = time.perf_counter()
        cpu = cpu_twin(cls, model)
        row["cpu"], cpu_f8 = compare(cpu, "cpu")
        row["cpu_vs_card_final_max_abs"] = float(np.abs(cpu_f8 - f8).max())
        row["cpu_s"] = time.perf_counter() - t0
        del cpu
    del model, locs
    torch.cuda.empty_cache()
    if not (card["round1_max_abs"] <= tol[0]
            and card["final_max_abs"] <= tol[1]
            and row.get("cpu", card)["round1_max_abs"] <= tol[0]):
        fail(f"{family}: batch 1 and batch 8 disagree: {row}")
    return row


def serving_export(torch, dev, procs):
    """S2GP and G2SP exported with their ``SERVING_EXPORT_SIZES`` by
    ``procs`` (``start_exports``); the live Localizers of the same weights
    and the artifact's batch size predict 9 images (8 and a tail of 1 at
    batch 8, or 9 single images); then a fresh process serves each
    artifact through ``ExportedLocalizer`` (``EXPORTED_CHILD``): its
    launches (exactly 15 of the solver kernel per batch it runs, through
    the custom ops), its outputs against the live ones (bit for bit) and
    its latency for one image.  That the batch size changes no answer
    beyond its limit, ``serving_cross_batch`` checks on the live model."""
    from highlyaccurate_tpu_torch.inference import Localizer
    rows, live, keys = [], {}, {}
    for family, proc in procs.items():
        cfg, _, kw, _, key = serving_family(torch, dev, family)
        loc = Localizer(cfg, random_init=True, seed=0, **kw,
                        batch_size=max(SERVING_EXPORT_SIZES[family]))
        root = f"{SERVING_ROOT}/{family}"
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"export of {family} exited {proc.returncode}: see "
                 f"{root}_export.log")
        child = json.loads(out.strip().splitlines()[-1])
        if child["weights"] != weights_sum(loc.model):
            fail(f"export of {family}: other weights than the live model")
        sat, grd = serve_images(cfg, 12, BATCH + 1)
        live[family] = loc.predict(sat, grd)
        np.savez(root + "_in.npz", sat=sat, grd=grd)
        keys[family] = key
        rows.append(dict(family=family,
                         batch_sizes=SERVING_EXPORT_SIZES[family],
                         export_s=child["export_s"], artifact_mb=
                         os.path.getsize(root + ".zip") / 1e6))
        del loc
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", EXPORTED_CHILD, *procs],
                         capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"ExportedLocalizer process exited {run.returncode}: "
             f"{run.stderr[-4000:]}")
    children = [json.loads(ln) for ln in run.stdout.splitlines()
                if ln.startswith("{")]
    for row, child in zip(rows, children):
        family = row["family"]
        batches = -(-(BATCH + 1) // max(row["batch_sizes"]))
        want = {k: 15 * batches if k == keys[family] else 0
                for k in child["launches"]}
        if child["launches"] != want:
            fail(f"exported {family} launched {child['launches']}, "
                 f"expected {want}")
        got = np.load(f"{SERVING_ROOT}/{family}_out.npz")
        cfg = serving_family(torch, dev, family)[0]
        scale = np.array([cfg.shift_range_lat, cfg.shift_range_lon,
                          cfg.rotation_range])
        diff = np.stack([np.abs(got[k] - live[family][k]) for k in
                         ("lateral_m", "longitudinal_m", "heading_deg")],
                        -1) / scale
        row.update(child, bit_equal=bool((diff == 0).all()),
                   max_abs_normalized=float(diff.max()), child_s=child_s)
        if not row["bit_equal"]:
            fail(f"exported {family} differs from the live Localizer: "
                 f"{row}")
    return rows


def op_overhead(torch, dev):
    """Host microseconds per K1 launch through its custom op and through
    the ctypes launch the op wraps (what the eager path cost before the
    op): 500 calls each at one small shape (batch 8, A 64, C 64, 16 rows
    of 64 samples), where the host's enqueue bounds the call, in turns
    ctypes / op / op / ctypes."""
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    g = torch.Generator(device=dev).manual_seed(0)
    B, A, C, V, W = 8, 64, 64, 16, 64
    sat = torch.rand(B, A, A, C, generator=g, device=dev).to(torch.bfloat16)
    grd = torch.rand(B, V, W, C, generator=g, device=dev)
    mask = torch.ones(V, W, device=dev)
    uv0 = torch.rand(B, V, 2, generator=g, device=dev) * 20 + 4
    coefs = bw.pack_row_coefs(uv0, uv0 + torch.tensor([1.0, 0.1],
                                                      device=dev),
                              A, bw.default_rb(A), W)

    def per_call(fn):
        fn(sat, grd, mask, coefs, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn(sat, grd, mask, coefs, True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 500 * 1e6

    turns = [per_call(fn) for fn in (bw._launch, bw._banded_moments_op,
                                     bw._banded_moments_op, bw._launch)]
    return dict(ctypes_us=[turns[0], turns[3]], custom_op_us=turns[1:3])


def phase_serving_api(torch, dev):
    """The rest of the serving API at the flagship widths (level 3,
    N_iters 5, sat 512, grd 256x1024, fp32 features, bf16 map, random
    weights, seeded images): the host cost of K1's custom op
    (``op_overhead``), ``return_cov`` for S2GP, G2SP and Ford at
    batch 8 (``serving_cov``), multi-start for S2GP and G2SP
    (``serving_multi_start``), ``calibrate`` (``serving_calibrate``),
    the same images at batch 1 and 8 (``serving_cross_batch``) and
    ``export`` / ``ExportedLocalizer`` (``serving_export``; the two
    exports, one program each, trace at once in processes of their own,
    after the timed windows, beside the cross-batch check).  Prints one
    JSON line."""
    t_start = time.perf_counter()
    overhead = op_overhead(torch, dev)
    cov, locs = [], {}
    for family in ("S2GP", "G2SP", "Ford"):
        row, locs[family] = serving_cov(torch, dev, family)
        cov.append(row)
    calib = serving_calibrate(torch, locs["S2GP"])
    del locs
    torch.cuda.empty_cache()
    multi = [serving_multi_start(torch, dev, f) for f in ("S2GP", "G2SP")]
    torch.cuda.empty_cache()
    # the two traces run at once, after the timed windows (each holds a
    # core of the host the windows' launches need), beside the untimed
    # cross-batch check
    procs = start_exports(("S2GP", "G2SP"))
    try:
        cross = [serving_cross_batch(torch, dev, f, cpu_too=f == "S2GP")
                 for f in ("S2GP", "G2SP")]
        exported = serving_export(torch, dev, procs)
        torch.cuda.empty_cache()
    finally:
        for proc in procs.values():   # stopped here if a check failed
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    row = dict(phase="serving_api", config="level 3, N_iters 5, sat 512, "
               "grd 256x1024, fp32 features, bf16 map, TF32 off, random "
               "weights", k1_host_us_per_launch=overhead, return_cov=cov,
               calibrate=calib, multi_start=multi, cross_batch=cross,
               export=exported, seconds=time.perf_counter() - t_start)
    emit(row)
    return row


SOLVER_BATCHES = 3      # each solver-option serving window
SOLVER_TRAIN_STEPS = 2  # each solver-option train window, after a warm-up
SOLVER_SEED = {"S2GP": 0, "G2SP": 2, "Ford": 4}  # the banded phases' images
# per configuration: (family, Config overrides, kernel launches per
# serving batch or None (no serving window), per train step or None);
# {} = no hand kernel
SOLVER_OPTIONS = {
    "S2GP level_first": ("S2GP", dict(level_first=1), {"k1": 15},
                         {"k2": 15, "k3": 15}),
    "S2GP dropout": ("S2GP", dict(dropout=1), {"k2": 15},
                     {"k2": 15, "k3": 15}),
    "S2GP ADAM": ("S2GP", dict(Optimizer="ADAM"), {"k2": 15}, None),
    "S2GP NN": ("S2GP", dict(Optimizer="NN"), {"k2": 15},
                {"k2": 15, "k3": 15}),
    "S2GP using_weight": ("S2GP", dict(using_weight=1), {}, None),
    "S2GP loss_method=3": ("S2GP", dict(loss_method=3), None, {}),
    "Ford GN": ("Ford", dict(Optimizer="GN"), {"k2": 15},
                {"k2": 15, "k3": 15}),
    "G2SP using_weight": ("G2SP", dict(using_weight=1), {}, None),
}
# card vs CPU at batch 2 (see PERF.md section 6), each limit between the
# reading and the card with TF32 convolutions: the round-1 pose of serving
# (ADAM's first step is lr * sign(gradient), so its round 1 reads 1 ulp
# of 0.01 on the card and 3 with TF32: the limit passes 2 ulps and fails
# a flipped sign; its later steps divide by gradients near zero, and round
# 2 reads 3.6e-4, beyond TF32's 2.3e-4), and the loss and gradients (relL2
# over all parameters; NN: of the worst tensor, since the head's gradients
# dominate the sum) of one train step (NN's loss reads 0 both ways: its
# random head moves the pose by ~1e-9, below the loss's last bit)
SOLVER_ROUND1_TOL = {"S2GP level_first": 3e-5, "S2GP dropout": 3e-5,
                     "S2GP ADAM": 2.5e-9, "S2GP NN": 2e-8,
                     "S2GP using_weight": 2e-6, "Ford GN": 3e-4,
                     "G2SP using_weight": 1e-6}
SOLVER_TRAIN_TOL = {
    "S2GP level_first": {"loss_rel_err": 2e-4, "grad_rel_l2_all": 3e-2},
    "S2GP dropout": {"loss_rel_err": 3e-4, "grad_rel_l2_all": 5e-2},
    "S2GP NN": {"loss_rel_err": 1e-6, "grad_rel_l2_max": 2e-3},
    "S2GP loss_method=3": {"loss_rel_err": 3e-5},
    "Ford GN": {"loss_rel_err": 3e-4, "grad_rel_l2_all": 5e-2},
}


def solver_draws(torch, cfg, model, n):
    """The random numbers of a forward of n images of ``cfg`` (the
    dropout's and the re-init's), drawn on the CPU, so that the card and
    the CPU twin get the same (their generators give other streams)."""
    from highlyaccurate_tpu_torch.models.lm_s2gp import (
        eval_draws_per_batch, eval_draws_per_image)
    count = (eval_draws_per_image(cfg, model.lm_cfg) * n
             + eval_draws_per_batch(cfg))
    return torch.rand(count, generator=torch.Generator().manual_seed(0)
                      ) * 2 - 1


def solver_serving(torch, dev, name, family, over, per_batch, tol=None,
                   prepare=None, gt_depth=None):
    """One configuration's serving: a window of ``SOLVER_BATCHES``
    batches of ``Localizer.predict`` with exact launch counts, and the
    trajectory of the card against a CPU run at batch 2 on the same
    draws (``solver_draws``) within ``tol`` (default
    ``SOLVER_ROUND1_TOL[name]``).  ``prepare(model)`` changes the fresh
    weights before anything runs; ``gt_depth`` [n, H, W] (host): a second
    window of the model's forward with it (``Localizer.predict`` takes no
    depth), which the card-vs-CPU check reads too."""
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.solver.updates import PresetDraws
    cfg, cls, loc_kw, extra, _ = serving_family(torch, dev, family, **over)
    t0 = time.perf_counter()
    loc = Localizer(cfg, random_init=True, batch_size=BATCH, seed=0,
                    **loc_kw)
    if prepare is not None:
        prepare(loc.model)
    init_s = time.perf_counter() - t0
    sat, grd = serve_images(cfg, SOLVER_SEED[family], BATCH * SOLVER_BATCHES)
    out, wall, counts, peak_gb = serve_window(
        torch, loc, sat, grd, f"{name} serving", per_batch)
    model = loc.model
    row = dict(frames_per_s=out["lateral_m"].shape[0] / wall,
               ms_per_batch=wall / SOLVER_BATCHES * 1e3, batches=
               SOLVER_BATCHES, peak_mem_gb=peak_gb, init_s=init_s,
               launches_per_batch={k: v // SOLVER_BATCHES
                                   for k, v in counts.items() if v})
    depth = {}
    if gt_depth is not None:
        row["gt_depth_window"] = depth_window(torch, dev, model, sat, grd,
                                              gt_depth, f"{name} gt_depth",
                                              per_batch)
        depth = dict(gt_depth=torch.from_numpy(gt_depth[:2]))
    s2, g2 = first_batch(torch, dev, sat, grd)
    numbers = solver_draws(torch, cfg, model, 2)
    cpu = cpu_twin(cls, model)

    def traj(m, device):
        kw = ({} if family == "G2SP"
              else dict(generator=PresetDraws(numbers.to(device))))
        kw.update({k: v.to(device) for k, v in depth.items()})
        return m(s2[:2].to(device), g2[:2].to(device), *extra(2, device),
                 mode="trajectory", **kw)

    row["traj_card_vs_cpu"] = traj_vs_cpu(
        torch, lambda: traj(model, dev), lambda: traj(cpu, "cpu"),
        SOLVER_ROUND1_TOL[name] if tol is None else tol, name)
    del cpu, loc, model
    torch.cuda.empty_cache()
    return row


def depth_window(torch, dev, model, sat, grd, gt_depth, what, per_batch):
    """``SOLVER_BATCHES`` evaluation forwards of batch 8 with the
    ``gt_depth`` lift (after a warm-up one), launch counts exact:
    frames/s, ms/batch, peak memory."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(i):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        return (*(torch.from_numpy(a[sl].astype(np.float32) / 255.0).to(dev)
                  for a in (sat, grd)),
                torch.from_numpy(gt_depth[sl]).to(dev))

    with torch.no_grad():
        s, g, d = batch(0)
        model(s, g, generator=gen, gt_depth=d)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        outs = [model(b[0], b[1], generator=gen, gt_depth=b[2])
                for b in map(batch, range(SOLVER_BATCHES))]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_launches(what, {k: v * SOLVER_BATCHES
                                    for k, v in per_batch.items()})
    if not all(bool(torch.isfinite(t).all()) for o in outs for t in o):
        fail(f"{what}: non-finite poses")
    return dict(frames_per_s=BATCH * SOLVER_BATCHES / wall,
                ms_per_batch=wall / SOLVER_BATCHES * 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_batch={k: v // SOLVER_BATCHES
                                    for k, v in counts.items() if v})


def solver_train(torch, dev, name, family, over, per_step, tol=None,
                 prepare=None, gt_depth=None):
    """One configuration's training at batch 8: a warm-up step, then
    ``SOLVER_TRAIN_STEPS`` steps with exact launch counts (ms/step, peak
    memory); then one training forward and backward of the card against a
    CPU run at batch 2 on the initial weights and the same draws: the
    loss, and every gradient's relL2 (loss method 3: which tensors are
    NaN, as in JAX), beside the card with TF32 convolutions, within
    ``tol`` (default ``SOLVER_TRAIN_TOL[name]``).  ``prepare(model)``
    changes the initial weights; ``gt_depth`` [n, H, W] (host, n >= 8):
    the depth every step's forward lifts with."""
    from highlyaccurate_tpu_torch.params import init_params
    from highlyaccurate_tpu_torch.solver.updates import PresetDraws
    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step
    cfg, cls, _, extra, _ = serving_family(torch, dev, family, **over)
    model = cls(cfg, device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    if prepare is not None:
        prepare(model)
    weights = {k: v.detach().cpu().clone()
               for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg, **(
        dict(ford_side_m=FORD_SIDE_M) if family == "Ford" else {}))
    rng = np.random.RandomState(SOLVER_SEED[family] + 1)
    n = SOLVER_TRAIN_STEPS + 1
    sat = torch.from_numpy((rng.rand(n, BATCH, cfg.sat_size, cfg.sat_size,
                                     3) * 255).astype(np.uint8)).to(dev)
    grd = torch.from_numpy((rng.rand(n, BATCH, cfg.grd_h, cfg.grd_w, 3)
                            * 255).astype(np.uint8)).to(dev)
    gt = torch.from_numpy(rng.uniform(-1, 1, (n, BATCH, 3)).astype(
        np.float32)).to(dev)
    ext = extra(BATCH, dev)
    extra_step = ext[1:] if family == "Ford" else ext
    depth = (None if gt_depth is None
             else torch.from_numpy(gt_depth[:BATCH]).to(dev))
    step_kw = {} if depth is None else dict(gt_depth=depth)

    def batch(i, b=BATCH):
        return (sat[i, :b].float() / 255.0, grd[i, :b].float() / 255.0,
                *(e[:b] for e in extra_step), gt[i, :b])

    gen = torch.Generator(device=dev).manual_seed(0)
    state, m = step(state, *batch(0), gen, **step_kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(1, n):
        state, m = step(state, *batch(i), gen, **step_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_launches(f"{name} train",
                             {k: v * SOLVER_TRAIN_STEPS
                              for k, v in per_step.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, step, model
    torch.cuda.empty_cache()

    # card vs CPU at batch 2 on the initial weights and the same draws
    b2 = batch(0, TRAIN_CHECK_BATCH)
    loss_of = {"S2GP": s2gp_loss, "G2SP": g2sp_loss,
               "Ford": ford_loss}[family]
    if depth is not None:
        b2 = (*b2, depth[:TRAIN_CHECK_BATCH])
        loss_of = s2gp_depth_loss
    cpu = cls(cfg, device="cpu")
    cpu.load_state_dict(weights)
    card = cls(cfg, device=dev)
    card.load_state_dict(weights)
    numbers = solver_draws(torch, cfg, cpu, TRAIN_CHECK_BATCH)

    def run(m, data, device):
        return train_grads(torch, m, loss_of, data,
                           PresetDraws(numbers.to(device)))

    t0 = time.perf_counter()
    loss_c, grads_c = run(cpu, [t.cpu() for t in b2], "cpu")
    cpu_s = time.perf_counter() - t0
    grads_c = {k: g for k, g in grads_c.items() if g is not None}

    def compare():
        loss, grads = run(card, b2, dev)
        row = dict(loss_rel_err=abs(loss - loss_c) / abs(loss_c))
        if cfg.loss_method == 3:
            row["nan_tensors"] = sum(bool(torch.isnan(g).any())
                                     for g in grads_c.values())
            row["nan_tensors_agree"] = all(
                bool(torch.isnan(grads[k]).any()) == bool(
                    torch.isnan(g).any()) for k, g in grads_c.items())
        else:
            row.update(grad_errors(torch, grads, grads_c))
        return row

    check = compare()
    torch.backends.cudnn.allow_tf32 = True
    try:
        check_tf32 = compare()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del cpu, card
    torch.cuda.empty_cache()
    failed = [k for k, lim in (SOLVER_TRAIN_TOL[name] if tol is None
                               else tol).items() if not check[k] <= lim]
    if cfg.loss_method == 3 and not check["nan_tensors_agree"]:
        failed.append("nan_tensors_agree")
    if failed:
        fail(f"{name} train step, card vs CPU: {failed}: {check}")
    return dict(ms_per_step=wall / SOLVER_TRAIN_STEPS * 1e3,
                steps=SOLVER_TRAIN_STEPS, peak_mem_gb=peak_gb,
                launches_per_step={k: v // SOLVER_TRAIN_STEPS
                                   for k, v in counts.items() if v},
                card_vs_cpu=dict(batch=TRAIN_CHECK_BATCH, cpu_s=cpu_s,
                                 cpu_loss=loss_c, **check,
                                 tf32_convs=check_tf32))


def phase_solver_options(torch, dev, only=None):
    """The solver options at the flagship widths and depth (level 3,
    N_iters 5, sat 512, grd 256x1024, batch 8, fp32 features, bf16 map,
    TF32 off; random weights and the banded phases' seeded images), each
    configuration of ``SOLVER_OPTIONS`` (``only``: a subset of its names):
    a serving window and a train window with exact launch counts, each
    against a CPU run of the port at batch 2 (``solver_serving``,
    ``solver_train``).  Prints one JSON line per configuration and the
    phase's seconds."""
    t_phase = time.perf_counter()
    for name, (family, over, per_batch, per_step) in SOLVER_OPTIONS.items():
        if only and name not in only:
            continue
        row = dict(phase="solver_options", config=name, family=family,
                   overrides=over, limits=dict(
                       serving=SOLVER_ROUND1_TOL.get(name),
                       train=SOLVER_TRAIN_TOL.get(name)))
        if per_batch is not None:
            row["serving"] = solver_serving(torch, dev, name, family, over,
                                            per_batch)
        if per_step is not None:
            row["train"] = solver_train(torch, dev, name, family, over,
                                        per_step)
        emit(row)
    emit(dict(phase="solver_options_total",
              seconds=time.perf_counter() - t_phase))


# The projection and depth options (each leaves the banded path, as in JAX,
# so no hand kernel may launch): (family, Config overrides).  S2GP nn builds
# the rays of S2GP polar, and Ford nn those of Ford polar (the CPU tests
# hold them to JAX).
PROJ_OPTIONS = {
    "S2GP polar": ("S2GP", dict(proj="polar")),
    "S2GP use_gt_depth": ("S2GP", dict(use_gt_depth=1)),
    "G2SP nn": ("G2SP", dict(proj="nn")),
    "G2SP polar": ("G2SP", dict(proj="polar")),
    "Ford polar": ("Ford", dict(proj="polar")),
    "Ford estimate_depth": ("Ford", dict(estimate_depth=1)),
}
# card vs CPU at batch 2, each limit between the card's reading and the
# card's with TF32 convolutions (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# section 6): the round-1 pose, about 10x the reading and at least 18x
# under TF32's; the train step's loss and gradients (relL2 over all
# parameters), about 10x the readings.  G2SP nn's loss reads 8.2e-8 both
# ways (its random weights barely move the pose), so its loss limit is
# fixed at 1e-6 and its gradients carry the check.
PROJ_ROUND1_TOL = {"S2GP polar": 1e-6, "S2GP use_gt_depth": 1e-6,
                   "G2SP nn": 1e-7, "G2SP polar": 3e-7, "Ford polar": 3e-6,
                   "Ford estimate_depth": 3e-6}
PROJ_TRAIN_TOL = {
    "S2GP polar": {"loss_rel_err": 2e-5, "grad_rel_l2_all": 1e-2},
    "S2GP use_gt_depth": {"loss_rel_err": 3e-6, "grad_rel_l2_all": 1e-2},
    "G2SP nn": {"loss_rel_err": 1e-6, "grad_rel_l2_all": 5e-3},
    "G2SP polar": {"loss_rel_err": 1e-6, "grad_rel_l2_all": 1.5e-2},
    "Ford polar": {"loss_rel_err": 3e-5, "grad_rel_l2_all": 1e-2},
    "Ford estimate_depth": {"loss_rel_err": 3e-5, "grad_rel_l2_all": 2e-2},
}
# the CLI run of a new flag: (family, flags, CLI_RUNS key)
PROJ_CLI = {"G2SP nn": ("G2SP", ["--proj", "nn"]),
            "Ford estimate_depth": ("Ford", ["--estimate_depth", "1"])}


def proj_gt_depth(cfg, n, seed=7):
    """A seeded depth map [n, grd_h, grd_w] of 1-30 m with about 10% of
    the pixels -1 (unknown), host float32."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(1.0, 30.0, (n, cfg.grd_h, cfg.grd_w)).astype(np.float32)
    d[rng.rand(n, cfg.grd_h, cfg.grd_w) < 0.1] = -1.0
    return d


def draw_depth_heads(torch, model):
    """The ground branch's depth heads' last conv drawn from N(0, 0.05)
    (seeded on the CPU) in place of its zero init, so the lift moves the
    rays."""
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for i in range(4):
            w = getattr(model.GrdFeatureNet, f"depth{i}")[3].weight
            w.copy_(torch.randn(w.shape, generator=g) * 0.05)


def proj_cli(torch, name):
    """One ``--synthetic`` epoch of a CLI with a new flag at the flagship
    defaults (cuDNN deterministic), no hand kernel in any step, then a
    ``--test 1 --compute_dtype float32`` reload of epoch 0's weights whose
    predictions must equal the in-training evaluation bit for bit."""
    import shutil
    from highlyaccurate_tpu_torch.config import config_from_args
    family, flags = PROJ_CLI[name]
    run = CLI_RUNS[family] + flags
    root = os.path.join(CLI_ROOT, name.replace(" ", "_"))
    troot = root + "_fp32"
    for r in (root, troot):
        shutil.rmtree(r, ignore_errors=True)
    mod = cli_module(family)
    argv = ["--test", "0", "--epochs", "1", "--save_root", root] + run
    cfg = config_from_args(mod.parse_args(argv))
    none = {"train": {}, "eval": {}}
    with deterministic_cudnn(torch):
        log, _, train_s = cli_run(torch, family, argv, {}, none)
        save_path = cli_save_path(family, cfg, root)
        trained = cli_results(family, save_path)
        tpath = cli_save_path(family, cfg, troot)
        os.makedirs(tpath)
        shutil.copy(os.path.join(save_path, "model_0.pth"), os.path.join(
            tpath, "Model_best.pth" if family == "Ford" else "model_1.pth"))
        _, _, reload_s = cli_run(torch, family, [
            "--test", "1", "--save_root", troot, "--compute_dtype",
            "float32"] + run, {}, none)
    fp32 = cli_results(family, tpath)
    bitwise = all(np.array_equal(fp32[k][0], trained[k][0]) for k in trained)
    finite = all(np.isfinite(v[0]).all() for v in trained.values())
    row = dict(train_steps=len(log["train"]), eval_batches=len(log["eval"]),
               run_s=train_s, reload_fp32_s=reload_s, save_path_suffix=
               os.path.basename(save_path).rsplit("_", 1)[-1],
               reload_fp32_bitwise_equal=bitwise)
    if not (bitwise and finite):
        fail(f"proj_options {name} CLI: reload bit for bit {bitwise}, "
             f"finite {finite}")
    return row


def phase_proj_options(torch, dev, only=None):
    """The projection and depth options at the flagship widths and depth
    (level 3, N_iters 5, sat 512, grd 256x1024, batch 8, fp32 features,
    bf16 map setting, TF32 off; random weights and the banded phases'
    seeded images), each configuration of ``PROJ_OPTIONS`` (``only``: a
    subset of its names): a serving window of ``SOLVER_BATCHES`` batches
    of ``Localizer.predict`` (S2GP ``use_gt_depth``: also of the model's
    forward with a seeded ``gt_depth``) and a train window of
    ``SOLVER_TRAIN_STEPS`` steps, each with no K1-K6 launch, each against
    a CPU run of the port at batch 2 beside the card with TF32
    convolutions (``solver_serving``, ``solver_train``); Ford
    ``estimate_depth`` with the depth heads' last conv drawn non-zero;
    then one CLI epoch of G2SP ``--proj nn`` and Ford ``--estimate_depth
    1`` with a float32 reload, bit for bit (``proj_cli``).  Prints one
    JSON line per configuration and the phase's seconds."""
    t_phase = time.perf_counter()
    for name, (family, over) in PROJ_OPTIONS.items():
        if only and name not in only:
            continue
        cfg = serving_family(torch, dev, family, **over)[0]
        kw = dict(
            prepare=((lambda m: draw_depth_heads(torch, m))
                     if cfg.estimate_depth else None),
            gt_depth=(proj_gt_depth(cfg, BATCH * SOLVER_BATCHES)
                      if cfg.use_gt_depth else None))
        row = dict(phase="proj_options", config=name, family=family,
                   overrides=over, limits=dict(serving=PROJ_ROUND1_TOL[name],
                                               train=PROJ_TRAIN_TOL[name]))
        row["serving"] = solver_serving(torch, dev, name, family, over, {},
                                        tol=PROJ_ROUND1_TOL[name], **kw)
        row["train"] = solver_train(torch, dev, name, family, over, {},
                                    tol=PROJ_TRAIN_TOL[name], **kw)
        if name in PROJ_CLI:
            row["cli"] = proj_cli(torch, name)
        emit(row)
        torch.cuda.empty_cache()
    emit(dict(phase="proj_options_total",
              seconds=time.perf_counter() - t_phase))


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
        from highlyaccurate_tpu_torch import Config
        from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
        from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
        from highlyaccurate_tpu_torch.models.lm_s2gp import (
            LMS2GP, _scaled_default_k)
        from highlyaccurate_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run from the "
             "repository root")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    libs = _build.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              libraries={k: os.path.relpath(v) for k, v in libs.items()},
              ptxas={k: ptxas_lines(_build.build_log(k)) for k in libs}))

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    shapes = phase_kernels(torch, dev, flush)
    phase_kernel_edge_lines(torch, dev)
    shapes.update(phase_g2sp_kernels(torch, dev, flush))
    phase_kernel_edge_projlines(torch, dev)
    del flush
    k1, k2, k3 = (("banded_moments_kernel", 15), "banded_sample_kernel",
                  "banded_sample_backward_kernel")
    k4, k5 = "projline_sample_kernel", "projline_sample_backward_kernel"
    kitti = ("level 3, N_iters 5, fp32 features, bf16 map, TF32 off, Adam")

    row, forward = phase_main_path(torch, dev)
    eval_profile(torch, "profile", forward, row["forward_ms_per_batch"],
                 "chiprun_out/profile_eval_b8.txt", {"k1": k1})
    k1_launches = row["k1_launches"]
    del forward
    torch.cuda.empty_cache()
    train = train_phase(
        torch, dev, "train", f"KITTI S2GP geo LM, sat 512, grd 256x1024, "
        f"{kitti}", LMS2GP, Config(), 1, TRAIN_STEPS, lambda n: (),
        s2gp_loss, plain_k2_k3, TRAIN_TOL, ("k2", "k3"))
    train_profile(torch, "profile_train", train,
                  "chiprun_out/profile_train_b8.txt", {"k2": k2, "k3": k3})
    k2_launches, k3_launches = train["k2"], train["k3"]
    del train
    torch.cuda.empty_cache()

    row, forward = phase_g2sp_main_path(torch, dev)
    eval_profile(torch, "profile_g2sp", forward, row["forward_ms_per_batch"],
                 "chiprun_out/profile_g2sp_eval_b8.txt", {"k4": (k4, 15)})
    k4_launches = row["k4_launches"]
    del forward
    torch.cuda.empty_cache()
    g2sp = Config(direction="G2SP")
    k8 = torch.from_numpy(_scaled_default_k(g2sp)).to(dev)
    train = train_phase(
        torch, dev, "g2sp_train", f"KITTI G2SP geo LM, sat 512, grd "
        f"256x1024, default K, {kitti}", LMG2SP, g2sp, 3, G2SP_TRAIN_STEPS,
        lambda n: (k8.expand(n, 3, 3).contiguous(),), g2sp_loss, plain_k4_k5,
        G2SP_TRAIN_TOL, ("k4", "k5"))
    train_profile(torch, "profile_g2sp_train", train,
                  "chiprun_out/profile_g2sp_train_b8.txt",
                  {"k4": k4, "k5": k5})
    k5_launches = train["k5"]
    del train
    torch.cuda.empty_cache()

    row, forward = phase_g2sp_pixmom_main_path(torch, dev)
    eval_profile(torch, "profile_g2sp_pixmom", forward,
                 row["forward_ms_per_batch"],
                 "chiprun_out/profile_g2sp_pixmom_eval_b8.txt",
                 {"k6": ("projline_pixmom_kernel", 15), "k4": (k4, 0)})
    k6_launches = row["k6_launches"]
    del forward
    torch.cuda.empty_cache()

    row, forward = phase_ford_main_path(torch, dev)
    eval_profile(torch, "profile_ford", forward, row["forward_ms_per_batch"],
                 "chiprun_out/profile_ford_eval_b8.txt", {"k1": k1})
    del forward
    torch.cuda.empty_cache()
    train = train_phase(
        torch, dev, "ford_train", f"Ford LM_S2GP_Ford geo LM, sat 512 "
        f"(112.64 m), grd 256x1024, Ford FL rig, {kitti}", LMS2GPFord,
        Config(), 5, FORD_TRAIN_STEPS, lambda n: ford_rig(torch, n),
        ford_loss, plain_k2_k3, FORD_TRAIN_TOL, ("k2", "k3"),
        ford_side_m=FORD_SIDE_M)
    train_profile(torch, "profile_ford_train", train,
                  "chiprun_out/profile_ford_train_b8.txt",
                  {"k2": k2, "k3": k3})
    del train
    torch.cuda.empty_cache()

    phase_cli_kitti(torch, gpu)
    torch.cuda.empty_cache()
    phase_gather_main_path(torch, dev, gpu)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_cli_ford(torch, gpu)
    emit(dict(phase="cli_ford_total", seconds=time.perf_counter() - t0))
    torch.cuda.empty_cache()
    phase_serving_api(torch, dev)
    torch.cuda.empty_cache()
    phase_solver_options(torch, dev)
    torch.cuda.empty_cache()
    phase_proj_options(torch, dev)
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))

    # library_ms is null for all six: no single PyTorch call computes
    # them (grid_sample gives neither the derivatives, nor the edge quirk,
    # nor the in-front mask of the projective lines, nor K6's moments)
    emit({"kernels": [
        kernel_entry("banded_moments", "banded_moments.cu", 704,
                     k1_launches, shapes["banded_moments"]),
        kernel_entry("banded_sample", "banded_sampler.cu", 1046,
                     k2_launches, shapes["banded_sample"]),
        kernel_entry("banded_sample_backward", "banded_sampler.cu", 1147,
                     k3_launches, shapes["banded_sample_backward"]),
        kernel_entry("projline_sample", "projline_sampler.cu", 1821,
                     k4_launches, shapes["projline_sample"]),
        kernel_entry("projline_sample_backward", "projline_sampler.cu", 1963,
                     k5_launches, shapes["projline_sample_backward"]),
        kernel_entry("projline_pixmom", "projline_sampler.cu", 2190,
                     k6_launches, shapes["projline_pixmom"]),
    ]})
    print(f"gpu: {gpu}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


AB_SETUP = """
import torch, chip_smoke as cs
from highlyaccurate_tpu_torch.ops import _build
_build.build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
"""
# per A/B flag: the code of one turn after AB_SETUP, and the phases of the
# rows it prints
AB_RUNS = {
    "--ab-g2sp-kernels": ("""
cs.phase_g2sp_kernels(torch, dev, torch.empty(256 << 20, dtype=torch.uint8,
                                              device=dev))
""", ("kernel_check",)),
    "--ab-e2e": ("""
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
cs.phase_main_path(torch, dev)
torch.cuda.empty_cache()
cs.train_phase(torch, dev, "train", "KITTI S2GP", LMS2GP, Config(), 1,
               cs.TRAIN_STEPS, lambda n: (), cs.s2gp_loss, cs.plain_k2_k3,
               cs.TRAIN_TOL, ("k2", "k3"))
""", ("main_path", "train")),
}


def ab_turns(flag, parent):
    """``python3 chip_smoke.py FLAG DIR``: the run of ``AB_RUNS[FLAG]`` for
    the checkout in DIR (the parent commit, unpacked) and for this one, on
    one card, in turns parent / this / this / parent, each in a process of
    its own that builds its tree's kernels: ``--ab-g2sp-kernels`` times
    K4-K6 (``phase_g2sp_kernels``), ``--ab-e2e`` the S2GP serving and
    training cells (``phase_main_path``, ``train_phase``).  Prints every
    row of the run's phases with its tree and turn; fails if a run
    fails."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    code, phases = AB_RUNS[flag]
    here = os.path.dirname(os.path.abspath(__file__))
    print(gpu_line(), flush=True)
    for turn, tree in enumerate((parent, here, here, parent)):
        run = subprocess.run([sys.executable, "-c", AB_SETUP + code],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            fail(f"A/B turn {turn} in {tree} exited {run.returncode}: "
                 f"{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if row.get("phase") in phases:
                emit(dict(row, tree="parent" if tree == parent else "change",
                          turn=turn))


def phase_alone(phase, *args):
    """``python3 chip_smoke.py --serving-api``, ``--solver-options [NAME
    ...]`` or ``--proj-options [NAME ...]``: the kernels' build and that
    phase alone."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from highlyaccurate_tpu_torch.ops import _build
    _build.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"gpu: {gpu_line()}", flush=True)
    phase(torch, torch.device("cuda", 0), *args)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in AB_RUNS:
        ab_turns(sys.argv[1], os.path.abspath(sys.argv[2]))
    elif sys.argv[1:] == ["--serving-api"]:
        phase_alone(phase_serving_api)
    elif sys.argv[1:2] == ["--solver-options"]:
        phase_alone(phase_solver_options, sys.argv[2:])
    elif sys.argv[1:2] == ["--proj-options"]:
        phase_alone(phase_proj_options, sys.argv[2:])
    else:
        main()
