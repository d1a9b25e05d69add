"""Serving API (port of ``highlyaccurate_tpu/inference.py``).

    loc = Localizer(Config(), pth_path="model_1.pth")        # on the GPU
    out = loc.predict(sat_imgs, grd_imgs)   # numpy [N,A,A,3], [N,H,W,3]
    out["lateral_m"], out["longitudinal_m"], out["heading_deg"]     # [N]

    loc = Localizer(Config(direction="G2SP"), pth_path=..., camera_k=K)
    out = loc.predict(sat_imgs, grd_imgs)              # or camera_k=[N,3,3]

    loc = Localizer(Config(), pth_path=..., ford_extrinsics=(R_FL, T_FL),
                    ford_side_m=512 * 0.22)                 # Ford
    out = loc.predict(sat_imgs, grd_imgs)       # or R_FL=[N,3,3], T_FL=[N,3]

One object owns the model on its device, pads ragged batches to a fixed
batch size, and converts the normalized pose to meters and degrees.  Tracking
mode feeds the previous estimate back as a warm start:

    out = loc.predict(sat_t, grd_t, init_pose=out_prev)

Uncertainty: ``predict(..., return_cov=True)`` adds ``"cov"`` [N, 3, 3] over
(lateral_m, longitudinal_m, heading_deg), the residual-scaled inverse
Gauss-Newton information at the solution times ``cov_scale``, which
``calibrate`` fits on validation batches with ground truth.  Multi-start:
``Config(pose_hypotheses=P)`` solves from P initial poses per image and
keeps the one with the smallest feature residual.

Deployment: ``loc.export(path, batch_sizes=[1, 8])`` writes one
``torch.export`` program per batch size, the weights inside, into a zip
beside ``meta.json``; ``ExportedLocalizer(path)`` serves it without the
model code, the config or the checkpoint:

    loc.export("kitti_s2gp.zip", batch_sizes=[1, 8])
    srv = ExportedLocalizer("kitti_s2gp.zip")
    out = srv.predict(sat_imgs, grd_imgs)

This port serves KITTI S2GP and G2SP and Ford LM_S2GP_Ford.  G2SP takes the
camera intrinsics of the grd_h x grd_w input, per call or as a constructor
default; Ford takes the camera -> body extrinsics and the satellite patch's
side length in meters at construction, and per-image extrinsics per call.
Orbax checkpoints (``save_path=``) raise ``NotImplementedError``; the
sharded predict (JAX ``mesh=``) is not ported.
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from highlyaccurate_tpu_torch.config import Config
from highlyaccurate_tpu_torch.geometry.ford import sample_layouts
from highlyaccurate_tpu_torch.solver.updates import uniform_draws
from highlyaccurate_tpu_torch.utils.device import resolve_device

_EXPORT_FORMAT = "highlyaccurate_tpu_torch.localizer/1"


class Localizer:
    """Batched pose estimation over the KITTI S2GP or G2SP model
    (``cfg.direction``), or the Ford model when ``ford_extrinsics`` and
    ``ford_side_m`` are given.

    Weights come from exactly one of ``params`` (the JAX package's params
    pytree), ``pth_path`` (a reference checkpoint) or ``random_init=True``
    (untrained weights drawn from ``seed``; tests and smoke runs only).
    ``camera_k`` [3, 3] (G2SP only) is the default intrinsics of the
    grd_h x grd_w input for ``predict`` calls that pass none.  Ford needs
    both ``ford_extrinsics`` = (R_FL [3, 3], T_FL [3]), the default
    camera -> body extrinsics, and ``ford_side_m``, the satellite patch's
    side length in meters (the Ford data's 0.22 m per pixel times its
    side); the Ford chain is S2GP only.  ``cov_scale`` multiplies the
    covariance ``predict`` returns (``calibrate`` fits it).
    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run the plain PyTorch path on the host.
    """

    def __init__(self, cfg: Config, params=None, pth_path: Optional[str] = None,
                 batch_size: int = 8, seed: int = 0, random_init: bool = False,
                 device=None, save_path: Optional[str] = None,
                 ford_extrinsics=None, ford_side_m: Optional[float] = None,
                 camera_k=None, cov_scale: float = 1.0):
        from highlyaccurate_tpu_torch.models import ford, lm_g2sp, lm_s2gp
        from highlyaccurate_tpu_torch.params import (init_params, load_pth,
                                                     state_dict_from_jax)

        if save_path is not None:
            raise NotImplementedError("save_path= (orbax checkpoints) is not "
                                      "supported; pass pth_path= or params=")
        self._ford = ford_side_m is not None or ford_extrinsics is not None
        self._g2sp = cfg.direction == "G2SP"
        if self._ford and (ford_side_m is None or ford_extrinsics is None):
            raise ValueError("Ford serving needs both ford_extrinsics="
                             "(R_FL [3,3], T_FL [3]) and ford_side_m= "
                             "(satellite patch side length in meters)")
        if self._ford and self._g2sp:
            raise ValueError("the Ford chain is S2GP-only "
                             "(direction='G2SP' with ford_* contradicts it)")
        if camera_k is not None and not self._g2sp:
            raise ValueError("camera_k is a G2SP input (KITTI S2GP "
                             "precomputes rays from the fixed default K); "
                             "build with Config(direction='G2SP')")
        module = (ford if self._ford else lm_g2sp if self._g2sp
                  else lm_s2gp)
        module.check_supported(cfg)
        family = (ford.LMS2GPFord if self._ford else lm_g2sp.LMG2SP
                  if self._g2sp else lm_s2gp.LMS2GP)
        sources = sum([params is not None, pth_path is not None,
                       bool(random_init)])
        if sources != 1:
            raise ValueError("pass exactly one weight source: params=, "
                             "pth_path= or random_init=True")
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        # the raw GN covariance is optimistic when residuals correlate:
        # cov_scale is the empirical multiplier (calibrate() or a known one)
        self.cov_scale = float(cov_scale)
        self._calibrated = self.cov_scale != 1.0
        self._camera_k = (None if camera_k is None else
                          np.asarray(camera_k, np.float32).reshape(3, 3))
        self._ford_side_m = ford_side_m
        self._ford_R = self._ford_T = None
        if self._ford:
            R_FL, T_FL = ford_extrinsics
            self._ford_R = np.asarray(R_FL, np.float32).reshape(3, 3)
            self._ford_T = np.asarray(T_FL, np.float32).reshape(3)
        self.model = family(cfg, device=self.device)
        if random_init:
            init_params(self.model, torch.Generator().manual_seed(seed))
        else:
            sd = (state_dict_from_jax(params) if params is not None
                  else load_pth(pth_path,
                                depth=self.model.GrdFeatureNet.estimate_depth))
            self.model.load_state_dict(sd)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._steps = {}

    def _get_step(self, warm: bool, info: bool):
        """The eval step of the (warm_start, with_info) variant, made
        once."""
        from highlyaccurate_tpu_torch.train.step import make_eval_step

        if (warm, info) not in self._steps:
            self._steps[warm, info] = make_eval_step(
                self.model, self.cfg, ford_side_m=self._ford_side_m,
                warm_start=warm, with_info=info)
        return self._steps[warm, info]

    def predict(self, sat_imgs, grd_imgs, R_FL=None, T_FL=None,
                camera_k=None, init_pose=None,
                return_cov: bool = False) -> dict:
        """sat_imgs [N, A, A, 3], grd_imgs [N, H, W, 3] (float in [0, 1] or
        uint8).  Returns numpy {"lateral_m", "longitudinal_m",
        "heading_deg"}, each [N], denormalized as the reference eval does
        (reference train_kitti.py:77-80).

        Ford only: ``R_FL`` [N, 3, 3] / ``T_FL`` [N, 3] override the
        constructor's extrinsics per image (mixed camera rigs; on the
        banded path, images whose rigs take different kernel layouts,
        ``sample_layouts``, go in separate batches).
        G2SP only: ``camera_k`` [N, 3, 3] (or [3, 3], one rig), the
        intrinsics of the grd_h x grd_w input; required unless the
        constructor got ``camera_k=``.

        ``init_pose`` warm-starts the solver: the dict a previous
        ``predict`` returned or an [N, 3] array of (lateral_m,
        longitudinal_m, heading_deg).  With ``pose_hypotheses > 1`` it
        seeds hypothesis 0.

        ``return_cov=True`` adds ``"cov"`` [N, 3, 3]: the pose covariance
        over (lateral_m, longitudinal_m, heading_deg) from the solver's
        Gauss-Newton information at the solution (metric units; zero rows
        and columns on frozen DoFs), times ``cov_scale``.  The raw
        covariance ranks uncertainty but is optimistic in scale when
        residuals correlate: an uncalibrated Localizer warns.
        """
        cfg = self.cfg
        ranges = (cfg.shift_range_lat, cfg.shift_range_lon,
                  cfg.rotation_range)
        sat_imgs = np.asarray(sat_imgs)
        n = sat_imgs.shape[0]
        extras = _per_image_extras(n, self._ford, self._g2sp, self._ford_R,
                                   self._ford_T, self._camera_k, R_FL, T_FL,
                                   camera_k)
        warm = init_pose is not None
        if warm:
            extras["_init_pose"] = _init_to_normalized(init_pose, n,
                                                       self._ford, ranges)
        step = self._get_step(warm, return_cov)
        dev = self.device

        def run(sb, gb, eb):
            args = [_to_device(sb, dev), _to_device(gb, dev)]
            if self._ford:
                # the rig goes on the host: the model reads its layout there
                args += [torch.from_numpy(np.ascontiguousarray(eb[k]))
                         for k in ("R_FL", "T_FL")]
            elif self._g2sp:
                args.append(_to_device(eb["camera_k"], dev))
            if warm:
                args.append(_to_device(eb["_init_pose"], dev))
            return [t.cpu().numpy() for t in step(*args, self._generator)]

        sizes = [self.batch_size]
        swap = (sample_layouts(extras["R_FL"])
                if self._ford and not self.model._gather else None)
        if swap is not None and swap.any() != swap.all():
            # one launch takes one kernel layout: serve each apart
            grd_imgs, out = np.asarray(grd_imgs), {}
            for sel in (swap, ~swap):
                part = _batched_predict(
                    run, sat_imgs[sel], grd_imgs[sel], sizes, ranges,
                    {k: v[sel] for k, v in extras.items()}, return_cov)
                for k, v in part.items():
                    out.setdefault(k, np.empty((n,) + v.shape[1:],
                                               np.float32))[sel] = v
        else:
            out = _batched_predict(run, sat_imgs, grd_imgs, sizes, ranges,
                                   extras, return_cov)
        if return_cov:
            if not self._calibrated:
                warnings.warn(
                    "Localizer covariance is UNCALIBRATED (cov_scale=1.0): "
                    "the raw Gauss-Newton covariance ranks uncertainty but "
                    "is strongly optimistic in scale (the JAX package's "
                    "synthetic tracking study measured ~5000x). Fit the "
                    "scale with Localizer.calibrate(validation_batches) or "
                    "pass cov_scale= before fusing 'cov' in a filter.",
                    stacklevel=2)
            out["cov"] = _cov_to_metric(out["cov"], self._ford,
                                        ranges) * self.cov_scale
        return out

    def calibrate(self, batches, dof_mask=None) -> float:
        """Fit ``cov_scale`` on validation data and store it (port of JAX
        ``Localizer.calibrate``).

        The raw Gauss-Newton covariance ranks per-image uncertainty but
        its scale is optimistic when residuals correlate (neighbouring
        feature pixels are not independent measurements).  This fits the
        one scalar that makes the Mahalanobis statistic consistent:
        ``scale = mean(z^2) / dof`` with ``z^2 = err^T C_raw^{-1} err``, in
        float64 on the host.

        ``batches``: an iterable of dicts with ``sat`` [N, A, A, 3],
        ``grd`` [N, H, W, 3] and ``gt_pose`` [N, 3] metric (lateral_m,
        longitudinal_m, heading_deg); optional ``R_FL`` / ``T_FL`` /
        ``camera_k`` / ``init_pose`` go to :meth:`predict` (``init_pose``
        near the truth calibrates the tracking regime).  ``dof_mask``: an
        optional length-3 bool of the DoFs to fit (frozen DoFs, whose rows
        of the raw covariance are zero, are left out in any case).

        Sets and returns ``self.cov_scale``; later ``predict(return_cov=
        True)`` calls and :meth:`export` artifacts use it.
        """
        errs, covs = [], []
        prev, prev_cal = self.cov_scale, self._calibrated
        self.cov_scale = 1.0  # the raw covariance during the fit
        self._calibrated = True  # and no uncalibrated warning inside it
        try:
            for b in batches:
                kw = {k: b[k] for k in ("R_FL", "T_FL", "camera_k",
                                        "init_pose") if k in b}
                out = self.predict(b["sat"], b["grd"], return_cov=True,
                                   **kw)
                gt = np.asarray(b["gt_pose"], np.float64)
                pred = np.stack([out["lateral_m"], out["longitudinal_m"],
                                 out["heading_deg"]], -1)
                errs.append(pred.astype(np.float64) - gt)
                covs.append(np.asarray(out["cov"], np.float64))
        finally:
            self.cov_scale, self._calibrated = prev, prev_cal
        if not errs:
            raise ValueError("calibrate() got an empty batch iterable")
        z2_sum, dof_sum = 0.0, 0
        for ee, cc in zip(np.concatenate(errs), np.concatenate(covs)):
            free = np.diagonal(cc) > 0  # frozen DoFs have zero rows/cols
            if dof_mask is not None:
                free = free & np.asarray(dof_mask, bool)
            if not free.any():
                continue
            z2_sum += float(ee[free] @ np.linalg.solve(
                cc[np.ix_(free, free)], ee[free]))
            dof_sum += int(free.sum())
        if dof_sum == 0:
            raise ValueError("calibrate(): every DoF is frozen, nothing to "
                             "fit (all covariance diagonals are zero)")
        self.cov_scale = z2_sum / dof_sum
        self._calibrated = True
        return self.cov_scale

    def export(self, path: str, batch_sizes=None, warm_start: bool = False,
               return_cov: bool = False) -> None:
        """Write a self-contained serving artifact (port of JAX
        ``Localizer.export``): for each of ``batch_sizes`` (default
        ``[self.batch_size]``) the eval forward (``EvalProgram``) traced by
        ``torch.export`` with the weights inside the program, each saved
        with ``torch.export.save``, zipped beside ``meta.json`` (the JAX
        artifact's keys; the device type in place of ``platforms``).
        ``ExportedLocalizer`` routes each chunk to the smallest exported
        size that fits, so ``[1, 8]`` serves a single image at batch-1
        latency.

        A torch program is exported for this Localizer's device type (JAX's
        ``platforms=`` has no counterpart): on the card it launches the
        hand kernels through their custom ops, and it loads only on that
        device type.  ``warm_start`` bakes in the ``init_pose`` input,
        ``return_cov`` the covariance output (scaled by the ``cov_scale``
        stored now).  Ford's banded kernel layout is fixed by the
        constructor's rig; the artifact refuses a rig of the other layout.
        """
        from highlyaccurate_tpu_torch.train.step import EvalProgram

        cfg = self.cfg
        dev = self.device
        layout = (bool(sample_layouts(self._ford_R[None])[0])
                  if self._ford and not self.model._gather else None)
        program = EvalProgram(self.model, cfg, self._ford_side_m, warm_start,
                              return_cov, ford_layout=layout)
        sizes = sorted(set(batch_sizes or [self.batch_size]))
        blobs = {}
        for bs in sizes:
            def zeros(*shape):
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            args = [zeros(bs, cfg.sat_size, cfg.sat_size, 3),
                    zeros(bs, cfg.grd_h, cfg.grd_w, 3)]
            if self._ford:
                args += [zeros(bs, 3, 3), zeros(bs, 3)]
            elif self._g2sp:
                args.append(zeros(bs, 3, 3))
            if warm_start:
                args.append(zeros(bs, 3))
            args.append(zeros(program.n_draws(bs)))
            with torch.no_grad():
                exported = torch.export.export(program, tuple(args),
                                               strict=False)
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            blobs[bs] = buf.getvalue()
        meta = {
            "format": _EXPORT_FORMAT,
            "batch_size": max(sizes),
            "batch_sizes": sizes,
            "ford": self._ford,
            "g2sp": self._g2sp,
            "warm_start": warm_start,
            "return_cov": return_cov,
            "cov_scale": self.cov_scale,
            "shift_range_lat": cfg.shift_range_lat,
            "shift_range_lon": cfg.shift_range_lon,
            "rotation_range": cfg.rotation_range,
            "ford_R": None if not self._ford else self._ford_R.tolist(),
            "ford_T": None if not self._ford else self._ford_T.tolist(),
            "ford_layout": layout,
            "camera_k": (None if self._camera_k is None
                         else self._camera_k.tolist()),
            "device": dev.type,
            "draws_per_image": program.draws_per_image,
            "draws_per_batch": program.draws_per_batch,
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("meta.json", json.dumps(meta, indent=1))
            for bs, blob in blobs.items():
                z.writestr(f"program_b{bs}.pt2", blob)


class ExportedLocalizer:
    """Serve a ``Localizer.export`` artifact (port of JAX
    ``ExportedLocalizer``): its programs and metadata, and no model code,
    config or checkpoint.  It imports the port's ops modules only to
    register the custom ops the programs call (the kernels build at their
    first launch), and draws each batch's random numbers from its own
    generator seeded with ``seed``, as ``Localizer(seed=...)`` draws them,
    so the two give the same outputs on the same batches.

    JAX's artifact carries ``platforms=``; a torch program is exported for
    one device type, so this refuses, with ``ValueError``, an artifact of
    another device type than ``device`` (default ``cuda``, which raises
    without a GPU; ``"cpu"`` for a CPU artifact), and any other format,
    a JAX artifact included.
    """

    def __init__(self, path: str, seed: int = 0, device=None):
        # registers the custom ops the programs call
        from highlyaccurate_tpu_torch.ops import (  # noqa: F401
            banded_warp, projline)

        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            meta = (json.loads(z.read("meta.json"))
                    if "meta.json" in names else {})
            if meta.get("format") != _EXPORT_FORMAT:
                raise ValueError(f"{path}: not a highlyaccurate_tpu_torch "
                                 f"Localizer export artifact "
                                 f"(format={meta.get('format')!r})")
            sizes = sorted(meta["batch_sizes"])
            blobs = {bs: z.read(f"program_b{bs}.pt2") for bs in sizes}
        self.device = resolve_device(device)
        if self.device.type != meta["device"]:
            raise ValueError(f"{path} was exported for {meta['device']!r} "
                             f"but this process serves on "
                             f"{self.device.type!r}; export it on the "
                             "deployment device type")
        self.meta = meta
        self.batch_size = meta["batch_size"]
        self.batch_sizes = sizes
        self._ford = bool(meta["ford"])
        self._g2sp = bool(meta["g2sp"])
        self._warm = bool(meta["warm_start"])
        self._cov = bool(meta["return_cov"])
        self._ford_R = (np.asarray(meta["ford_R"], np.float32)
                        if self._ford else None)
        self._ford_T = (np.asarray(meta["ford_T"], np.float32)
                        if self._ford else None)
        self._camera_k = (np.asarray(meta["camera_k"], np.float32)
                          if meta["camera_k"] is not None else None)
        self._programs = {bs: torch.export.load(io.BytesIO(blob)).module()
                          for bs, blob in blobs.items()}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def predict(self, sat_imgs, grd_imgs, R_FL=None, T_FL=None,
                camera_k=None, init_pose=None) -> dict:
        """Same contract as ``Localizer.predict``.  ``init_pose`` needs a
        ``warm_start=True`` artifact (which without it runs the cold start
        from zero); a ``return_cov=True`` artifact always returns
        ``"cov"``; a Ford rig whose kernel layout (``sample_layouts``)
        differs from the exporting rig's raises ``ValueError``."""
        meta = self.meta
        ranges = (meta["shift_range_lat"], meta["shift_range_lon"],
                  meta["rotation_range"])
        sat_imgs = np.asarray(sat_imgs)
        n = sat_imgs.shape[0]
        extras = _per_image_extras(n, self._ford, self._g2sp, self._ford_R,
                                   self._ford_T, self._camera_k, R_FL, T_FL,
                                   camera_k)
        layout = meta["ford_layout"]
        if layout is not None and not (sample_layouts(extras["R_FL"])
                                       == layout).all():
            raise ValueError("a rig of this call takes the other banded "
                             "kernel layout than the exported program's "
                             f"(swap={layout}); export from a Localizer "
                             "with such a rig")
        if init_pose is not None and not self._warm:
            raise ValueError("this artifact was exported without "
                             "warm_start=True; it has no init_pose input")
        if self._warm:
            extras["_init_pose"] = (
                np.zeros((n, 3), np.float32) if init_pose is None
                else _init_to_normalized(init_pose, n, self._ford, ranges))
        dev = self.device

        def run(sb, gb, eb):
            bs = sb.shape[0]
            args = [_to_device(sb, dev), _to_device(gb, dev)]
            args += [_to_device(eb[k], dev) for k in
                     (("R_FL", "T_FL") if self._ford else
                      ("camera_k",) if self._g2sp else ())]
            if self._warm:
                args.append(_to_device(eb["_init_pose"], dev))
            n_draws = (meta["draws_per_image"] * bs
                       + meta["draws_per_batch"])
            args.append(uniform_draws(self._generator, (n_draws,), dev)
                        if n_draws else torch.zeros(0, device=dev))
            with torch.no_grad():
                outs = self._programs[bs](*args)
            return [t.cpu().numpy() for t in outs]

        out = _batched_predict(run, sat_imgs, grd_imgs, self.batch_sizes,
                               ranges, extras, self._cov)
        if self._cov:
            out["cov"] = (_cov_to_metric(out["cov"], self._ford, ranges)
                          * float(meta["cov_scale"]))
        return out


def _to_device(x, device) -> torch.Tensor:
    """A host array as float32 on ``device``; uint8 images cross as bytes
    and convert there (IEEE float32 x / 255, the same numbers as on the
    host)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t.to(torch.float32) / 255.0 if t.dtype == torch.uint8
            else t.to(torch.float32))


def _per_image_extras(n, ford, g2sp, ford_R, ford_T, default_k, R_FL,
                      T_FL, camera_k) -> dict:
    """The per-image model inputs of one call, [N, ...] arrays, from the
    call's overrides and the constructor's defaults: a Ford call's R_FL
    [N, 3, 3] and T_FL [N, 3]; a G2SP call's camera_k [N, 3, 3] (from
    [N, 3, 3] or [3, 3]); a KITTI S2GP call takes none."""
    if (R_FL is not None or T_FL is not None) and not ford:
        raise ValueError("R_FL/T_FL are Ford-chain extrinsics; this "
                         "localizer does not serve the Ford model")
    if camera_k is not None and not g2sp:
        raise ValueError("camera_k is a G2SP input; this localizer serves "
                         "an S2GP model (the fixed-K quirk: KITTI S2GP "
                         "precomputes rays from the default K)")

    def check(name, x, shape):
        x = np.asarray(x, np.float32)
        if x.shape != shape:
            raise ValueError(f"{name} must have shape {shape} to match the "
                             f"{shape[0]} images, got {x.shape}")
        return x

    if ford:
        return {
            "R_FL": (check("R_FL", R_FL, (n, 3, 3)) if R_FL is not None
                     else np.broadcast_to(ford_R, (n, 3, 3))),
            "T_FL": (check("T_FL", T_FL, (n, 3)) if T_FL is not None
                     else np.broadcast_to(ford_T, (n, 3))),
        }
    if not g2sp:
        return {}
    k = camera_k if camera_k is not None else default_k
    if k is None:
        raise ValueError("G2SP serving needs camera intrinsics: pass "
                         "camera_k= ([N,3,3] or [3,3]) to predict(), or a "
                         "default at construction")
    k = np.asarray(k, np.float32)
    if k.shape == (3, 3):
        k = np.broadcast_to(k, (n, 3, 3))
    return {"camera_k": check("camera_k", k, (n, 3, 3))}


def _init_to_normalized(init_pose, n, ford, ranges) -> np.ndarray:
    """[N, 3] normalized pose-order warm start from the dict a previous
    predict returned or an [N, 3] array of (lateral_m, longitudinal_m,
    heading_deg).  Pose order is the model's: KITTI (u = lon, v = lat,
    heading), Ford (u = lat, v = lon, heading).  A zero range freezes that
    DoF at 0."""
    if isinstance(init_pose, dict):
        init_pose = np.stack([np.asarray(init_pose["lateral_m"]),
                              np.asarray(init_pose["longitudinal_m"]),
                              np.asarray(init_pose["heading_deg"])], -1)
    p = np.asarray(init_pose, np.float32)
    if p.shape != (n, 3):
        raise ValueError(f"init_pose must have shape ({n}, 3) to match the "
                         f"{n} images, got {p.shape}")
    lat = p[:, 0] / ranges[0] if ranges[0] else np.zeros_like(p[:, 0])
    lon = p[:, 1] / ranges[1] if ranges[1] else np.zeros_like(p[:, 1])
    deg = p[:, 2] / ranges[2] if ranges[2] else np.zeros_like(p[:, 2])
    order = [lat, lon, deg] if ford else [lon, lat, deg]
    return np.stack(order, -1).astype(np.float32)


def _cov_to_metric(cov, ford, ranges) -> np.ndarray:
    """Normalized pose-order [N, 3, 3] covariance -> metric (lateral_m,
    longitudinal_m, heading_deg) order."""
    perm = np.array([0, 1, 2] if ford else [1, 0, 2])
    s = np.array(ranges, np.float32)
    cov = cov[:, perm[:, None], perm[None, :]]
    return cov * s[None, :, None] * s[None, None, :]


def _batched_predict(run, sat_imgs, grd_imgs, sizes, ranges, extras,
                     with_cov: bool = False) -> dict:
    """The predict loop: chunks of at most ``sizes[-1]`` images, each
    padded (with copies of its last image) to the smallest of ``sizes``
    (ascending) that fits, and the denormalization to meters and degrees.
    ``run(sat, grd, extras_batch)`` executes one padded batch of host
    arrays (uint8 or float, converted by ``run``) and returns numpy
    (lat, lon, theta[, cov]); ``extras`` holds per-image [N, ...] arrays,
    chunked and padded alike.  ``with_cov`` collects the 4th output, raw
    (normalized, pose order), under "cov"."""
    sat = np.asarray(sat_imgs)
    grd = np.asarray(grd_imgs)
    n = sat.shape[0]
    if n == 0:
        empty = np.zeros((0,), np.float32)
        out = {"lateral_m": empty, "longitudinal_m": empty,
               "heading_deg": empty}
        if with_cov:
            out["cov"] = np.zeros((0, 3, 3), np.float32)
        return out

    def pad_to(x, bs):
        pad = bs - x.shape[0]
        return x if not pad else np.concatenate(
            [x, np.repeat(x[-1:], pad, 0)])

    max_bs = sizes[-1]
    parts = []
    for i in range(0, n, max_bs):
        chunk = min(max_bs, n - i)
        bs = next(s for s in sizes if s >= chunk)
        sb = pad_to(sat[i:i + chunk], bs)
        gb = pad_to(grd[i:i + chunk], bs)
        eb = {k: pad_to(v[i:i + chunk], bs) for k, v in extras.items()}
        parts.append([o[:chunk] for o in run(sb, gb, eb)])
    lat, lon, th, *cov = (np.concatenate(p) for p in zip(*parts))
    out = {"lateral_m": lat * ranges[0], "longitudinal_m": lon * ranges[1],
           "heading_deg": th * ranges[2]}
    if with_cov:
        out["cov"] = cov[0]
    return out
