"""Training traffic: Adam steps of ``make_train_step`` on batches of uint8
frames from a seeded pool, fed through the port's host-to-device copy, with
seeded ground-truth poses.  Set-up makes the train state and drives its
first steps through the same call and feed as the window; the reference
follows those steps from the same weights."""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from benchmark.harness import check, inputs
from benchmark.harness.serve import port_config
from benchmark.reference import vgg

BETAS, EPS = (0.9, 0.999), 1e-8        # the optimizer the program states
BRANCHES = ("SatFeatureNet", "GrdFeatureNet")
SLOTS = (0, 1, 2)                      # level 3's feature maps


class Train:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.batch, self.pool_n = t["batch"], t["pool"]
        (self.w_seed, self.f_seed, self.s_seed,
         self.g_seed) = inputs.streams(seed)
        self.phases = {}         # set-up seconds by phase
        self.steps = 0
        self.losses = []         # the window's loss tensors

    def make_inputs(self):
        """The seeded weights, frame pool and poses, which both sides
        read."""
        m, ref = self.cell.config["model"], self.cell.reference
        self.weights = inputs.draw_weights(
            self.w_seed, ref.initial_damping(m), self.device)
        self.sat, self.grd = inputs.frame_pool(
            self.f_seed, self.pool_n, self.batch, m["sat_size"], m["grd_h"],
            m["grd_w"], self.cell.traffic["octaves"], self.device)
        self.gt = inputs.pose_pool(self.s_seed, self.pool_n, self.batch)

    def setup(self):
        from highlyaccurate_tpu_torch.train.state import create_train_state
        from highlyaccurate_tpu_torch.train.step import (make_train_step,
                                                         to_device)
        t = time.perf_counter()
        self.make_inputs()
        self.phases["inputs"] = time.perf_counter() - t
        self.cfg = port_config(self.cell)
        m, ref = self.cell.config["model"], self.cell.reference
        module, name = ref.MODEL_CLASS.rsplit(".", 1)
        model_class = getattr(importlib.import_module(module), name)
        self.model = model_class(self.cfg, device=self.device)
        self.model.load_state_dict(self.weights)
        self.model.train()
        self.state = create_train_state(self.cfg, self.model)
        self.step_fn = make_train_step(self.model, self.cfg,
                                       **ref.step_options(m))
        dev = torch.device(self.device)
        self.step_extras = [to_device(x, dev)
                            for x in ref.step_inputs(m, self.batch)]
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.g_seed)
        self.phases["program"] = time.perf_counter() - t
        self.first = self._first_steps(self.cell.traffic["checked_steps"])

    def _feed(self, p: int):
        from highlyaccurate_tpu_torch.train.step import to_device
        dev = torch.device(self.device)
        return (inputs.to_float(to_device(self.sat[p], dev)),
                inputs.to_float(to_device(self.grd[p], dev)),
                to_device(self.gt[p], dev))

    def step(self):
        sat, grd, gt = self._feed(self.steps % self.pool_n)
        self.state, metrics = self.step_fn(self.state, sat, grd,
                                           *self.step_extras, gt, self.gen)
        self.steps += 1
        return metrics["loss"]

    def feature_rows(self) -> list:
        """The images of step 1's batch whose features are compared, drawn
        from the seed."""
        rng = np.random.default_rng([self.s_seed, 1])
        n = self.cell.traffic["feature_images"]
        return sorted(rng.choice(self.batch, n, replace=False).tolist())

    def _first_steps(self, n: int) -> dict:
        """Steps 1..n, each on a batch of its own: their losses, the
        feature maps step 1's forward made of ``feature_rows``, the first
        gradient as Adam holds it after step 1 and the change of the
        weights after step n, per leaf."""
        names = {p: k for k, p in self.model.named_parameters()}
        rows, feats = self.feature_rows(), {}

        def keep(branch):
            def hook(module, args, out):
                feats[branch] = [f[rows].detach().float().cpu()
                                 if len(f) == self.batch else None
                                 for f in out[0]]
            return hook
        hooks = [getattr(self.model, b).register_forward_hook(keep(b))
                 for b in BRANCHES]
        losses, grad1 = [], {}
        for i in range(n):
            t = time.perf_counter()
            losses.append(float(self.step()))
            self.phases[f"step{i + 1}"] = time.perf_counter() - t
            if i == 0:
                for h in hooks:
                    h.remove()
                opt = self.state.optimizer
                grad1 = {names[p]: float(s["exp_avg"].norm()) / (1 - BETAS[0])
                         for p, s in opt.state.items() if "exp_avg" in s}
        change = {k: float((p.detach() - self.weights[k]).norm())
                  for k, p in self.model.named_parameters()}
        return {"loss": losses, "grad1": grad1, "change": change,
                "features": [f for b in BRANCHES for f in feats.get(b, [])]}

    def window(self, seconds: float = None, calls: int = None) -> dict:
        n = 0
        t0 = time.perf_counter()
        while True:
            self.losses.append(self.step())
            n += 1
            if calls is not None and n >= calls:
                break
            if calls is None and time.perf_counter() - t0 >= seconds:
                break
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(self.losses[-n:]))).sum())
        return {"calls": n, "attempted": n, "failed": failed,
                "train_fps": n * self.batch / elapsed}

    def release(self):
        del self.model, self.state, self.step_fn, self.losses
        torch.cuda.empty_cache()

    def check(self) -> dict:
        """The first steps against the reference's: each step's loss, step
        1's feature maps, the first gradient's norm and the weights' change
        per leaf."""
        ref = self.reference(len(self.first["loss"]))
        gaps = [abs(a - b) / abs(b) for a, b in
                zip(self.first["loss"], ref["loss"])]
        med = float(np.median([v for v in ref["grad1"].values() if v > 0]))
        counted = [k for k, v in ref["grad1"].items() if v >= 1e-3 * med]
        prog_grad = {k: self.first["grad1"].get(k, 0.0) for k in counted}
        grad = check.leaf_gaps(prog_grad, ref["grad1"], counted)
        step = check.leaf_gaps(self.first["change"], ref["change"], counted)
        return {"feat_gap": check.feature_gap(self.first["features"],
                                              ref["features"]),
                "loss1_gap": gaps[0], "loss_gap": max(gaps),
                "grad_gap_median": float(np.median(list(grad.values()))),
                "step_gap": max(step.values())}

    def reference(self, n: int, mode: str = None, rows: int = None) -> dict:
        """n Adam steps of the reference from the benchmark's weights on
        the same batches, poses and re-init numbers; the gradient summed
        over blocks of ``check_rows`` samples.  ``rows``: the first rows of
        each batch alone, the loss their mean (a planted fault: half of
        the batch left out)."""
        route, model = self.cell.route, self.cell.config["model"]
        with check.precision(mode or route["precision"]) as mode:
            out = self._reference(n, mode, route, model, rows)
            out["features"] = self._features(mode)
        return out

    @torch.no_grad()
    def _features(self, mode: str) -> list:
        """The reference's feature maps of step 1's ``feature_rows``, from
        the benchmark's weights, in ``mode``."""
        rows = self.feature_rows()
        out = []
        for b, frames in zip(BRANCHES, (self.sat[0], self.grd[0])):
            img = inputs.to_float(torch.from_numpy(frames[rows]).to(
                self.device))
            out += [f.float().cpu() for f in vgg.features(
                self.weights, f"{b}.", img, SLOTS, mode)]
        return out

    def _reference(self, n, mode, route, model, used=None):
        conf = {**model, **route}
        rows, B = self.cell.traffic["check_rows"], used or self.batch
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in self.weights.items()}
        adam = {}
        ref = self.cell.reference
        g = torch.Generator(device=self.device).manual_seed(self.g_seed)
        rounds, per_image = ref.reinit_draws(model)
        losses, grad1 = [], {}
        for step in range(1, n + 1):
            p = (step - 1) % self.pool_n
            draws = [torch.rand((per_image, self.batch), generator=g,
                                device=self.device) * 2 - 1
                     for _ in range(rounds)]
            grads = {k: None for k in theta}
            total = 0.0
            for i in range(0, B, rows):
                sl = slice(i, min(i + rows, B))
                sat = inputs.to_float(torch.from_numpy(
                    self.sat[p][sl]).to(self.device))
                grd = inputs.to_float(torch.from_numpy(
                    self.grd[p][sl]).to(self.device))
                gt = torch.from_numpy(self.gt[p][sl]).to(self.device)
                traj = ref.trajectory(theta, sat, grd, conf,
                                      lambda t: draws[t][:, sl], mode,
                                      route["sampler"])
                part = ref.loss(traj, gt).sum() / B
                total += float(part.detach())
                keys = list(theta)
                gs = torch.autograd.grad(part, [theta[k] for k in keys],
                                         allow_unused=True)
                for k, gk in zip(keys, gs):
                    if gk is not None:
                        grads[k] = gk if grads[k] is None else grads[k] + gk
            losses.append(total)
            with torch.no_grad():
                for k, gk in grads.items():
                    if gk is None:
                        continue
                    m, v = adam.setdefault(k, [torch.zeros_like(gk),
                                               torch.zeros_like(gk)])
                    m.mul_(BETAS[0]).add_(gk, alpha=1 - BETAS[0])
                    v.mul_(BETAS[1]).addcmul_(gk, gk, value=1 - BETAS[1])
                    mh = m / (1 - BETAS[0] ** step)
                    vh = v / (1 - BETAS[1] ** step)
                    theta[k] -= model["lr"] * mh / (vh.sqrt() + EPS)
            if step == 1:
                grad1 = {k: float(gk.norm()) if gk is not None else 0.0
                         for k, gk in grads.items()}
        change = {k: float((theta[k].detach() - self.weights[k]).norm())
                  for k in theta}
        return {"loss": losses, "grad1": grad1, "change": change}
