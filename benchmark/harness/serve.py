"""Serving traffic: a closed loop of one client calling
``Localizer.predict`` on batches of uint8 host frames from a seeded pool,
each call timed from the call to its poses on the host."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check, inputs


def port_config(cell):
    """The port's ``Config`` of the cell's model and route."""
    from highlyaccurate_tpu_torch import Config
    route = {k: v for k, v in cell.route.items()
             if k in Config.__dataclass_fields__}
    return Config(**cell.config["model"], **route)


class Serve:
    """set-up, the timed loop and the check of one serving cell."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.batch, self.pool_n = t["batch"], t["pool"]
        (self.w_seed, self.f_seed, self.s_seed,
         self.g_seed) = inputs.streams(seed)
        self.phases = {}         # set-up seconds by phase
        self.calls = 0           # predict calls so far, warm-up included
        self.outs = []           # (call, pool index, [B, 3] model-order pose)

    def make_inputs(self):
        """The seeded weights and frame pool, which both sides read."""
        m = self.cell.config["model"]
        self.weights = inputs.draw_weights(
            self.w_seed, self.cell.reference.initial_damping(m), self.device)
        self.sat, self.grd = inputs.frame_pool(
            self.f_seed, self.pool_n, self.batch, m["sat_size"], m["grd_h"],
            m["grd_w"], self.cell.traffic["octaves"], self.device)

    def setup(self):
        from highlyaccurate_tpu_torch.inference import Localizer
        m = self.cell.config["model"]
        t = time.perf_counter()
        self.make_inputs()
        self.phases["inputs"] = time.perf_counter() - t
        self.cfg = port_config(self.cell)
        self.loc = Localizer(self.cfg, random_init=True,
                             batch_size=self.batch, seed=self.g_seed,
                             device=self.device,
                             **self.cell.reference.localizer_inputs(m))
        self.loc.model.load_state_dict(self.weights)
        self.phases["program"] = time.perf_counter() - t
        for i in range(self.cell.traffic["warm_calls"]):
            self.phases[f"warm{i}"] = self.call(keep=False)

    def call(self, keep: bool = True) -> float:
        """One predict call on the next pool batch; its seconds."""
        p = self.calls % self.pool_n
        t0 = time.perf_counter()
        out = self.loc.predict(self.sat[p], self.grd[p])
        dt = time.perf_counter() - t0
        m, ref = self.cell.config["model"], self.cell.reference
        pose = np.stack([out[k] / m[r] for k, r in
                         zip(ref.POSE_KEYS, ref.POSE_RANGES)], -1)
        if keep:
            self.outs.append((self.calls, p, pose))
        self.calls += 1
        return dt

    def window(self, seconds: float = None, calls: int = None) -> dict:
        """Calls until ``seconds`` have passed (or ``calls`` were made)."""
        lat = []
        t0 = time.perf_counter()
        while True:
            lat.append(self.call())
            elapsed = time.perf_counter() - t0
            if (calls is not None and len(lat) >= calls) or (
                    calls is None and elapsed >= seconds):
                break
        n = len(lat) * self.batch
        self.latencies = lat
        return {"calls": len(lat), "attempted": n, "failed": 0,
                "serve_fps": n / elapsed,
                "serve_p90_ms": float(np.percentile(lat, 90)) * 1e3}

    def release(self):
        del self.loc
        torch.cuda.empty_cache()

    def check(self, program=None) -> dict:
        """The sampled answers against the reference.  ``program(p, idx,
        draws)``, where given, stands in for the program's answers: the
        control, the reference in another precision."""
        route, model = self.cell.route, self.cell.config["model"]
        spec = self.cell.traffic["check"]
        rng = np.random.default_rng(self.s_seed)
        picks = rng.choice(len(self.outs), min(spec["calls"],
                                               len(self.outs)),
                           replace=False)
        chosen = sorted(self.outs[i] for i in picks)
        draws = self._draws([c for c, _, _ in chosen])
        prog, ref = [], []
        for call, p, pose in chosen:
            idx = np.sort(rng.choice(self.batch, spec["images"],
                                     replace=False))
            prog.append(pose[idx] if program is None
                        else program(p, idx, draws.get(call)))
            ref.append(self.reference(p, idx, draws.get(call)))
        return check.pose_gaps(np.concatenate(prog), np.concatenate(ref))

    def _draws(self, calls) -> dict:
        """The re-init numbers each of ``calls`` drew: the program's
        generator replayed from its seed, call by call."""
        rounds, per_image = self.cell.reference.reinit_draws(
            self.cell.config["model"])
        g = torch.Generator(device=self.device).manual_seed(self.g_seed)
        out = {}
        for c in range(max(calls) + 1):
            d = torch.rand((rounds * per_image * self.batch,), generator=g,
                           device=self.device) * 2 - 1
            if c in calls:
                out[c] = d.view(rounds, per_image, self.batch)
        return out

    @torch.no_grad()
    def reference(self, p: int, idx, draws, mode: str = None):
        """The reference's final poses [len(idx), 3] (model order) of pool
        batch ``p``'s images ``idx``: the features of the batch's images in
        blocks of ``check_rows``, the rounds of those in ``idx``."""
        route, model = self.cell.route, self.cell.config["model"]
        rows = self.cell.traffic["check_rows"]
        ref = self.cell.reference
        out = []
        with check.precision(mode or route["precision"]) as mode:
            for i in range(0, self.batch, rows):
                sel = [j - i for j in idx if i <= j < i + rows]
                if not sel:
                    continue
                sat = inputs.to_float(torch.from_numpy(
                    self.sat[p][i:i + rows]).to(self.device))
                grd = inputs.to_float(torch.from_numpy(
                    self.grd[p][i:i + rows]).to(self.device))
                cols = torch.as_tensor(sel, device=self.device) + i
                traj = ref.trajectory(
                    self.weights, sat, grd, {**model, **route},
                    None if draws is None else (lambda t: draws[t][:, cols]),
                    mode, route["sampler"],
                    rows=torch.as_tensor(sel, device=self.device))
                out.append(traj[:, -1, -1].cpu().numpy())
        return np.concatenate(out)
