"""Port parity for the rest of the serving API: the pose covariance
(``lm_information`` / ``pose_covariance``, ``predict(return_cov=True)``,
``cov_scale``, ``calibrate``), multi-start inference
(``pose_hypotheses > 1``) and the multi-size predict loop, on the CPU
against the JAX package on the same params and inputs.

JAX runs its banded kernels with ``use_banded_warp=2`` (interpret mode)
where the port runs its banded path's plain versions.  The multi-start
initial poses are fed to both: JAX draws them with ``jax.random.uniform``
from a key torch cannot reproduce, so the test replaces that one
(B, P, 3) draw inside the JAX call, and the port's ``draw_starts``, with
the same numbers (the JAX package is unchanged).  The multi-start sweep
is in tests/test_torch_multi_start.py, export and ``ExportedLocalizer`` in
tests/test_torch_export.py.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.inference import Localizer as JLocalizer
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.solver import updates as jupd
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.inference import Localizer, _batched_predict
from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
from highlyaccurate_tpu_torch.solver import updates as tupd
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# fp32 map and features; N_iters=1 (3 rounds); G2SP at a 64-row ground
# input, so every level's ground map takes the projective-line sampler
GEOM = {"S2GP": dict(grd_h=32, grd_w=128, sat_size=64),
        "G2SP": dict(grd_h=64, grd_w=256, sat_size=128, direction="G2SP"),
        "Ford": dict(grd_h=64, grd_w=256, sat_size=128)}
BASE = dict(N_iters=1, level=3, banded_bf16_map=0)
FORD_R = np.array([[0.995, -0.04, 0.09], [0.05, 0.997, -0.06],
                   [-0.087, 0.064, 0.994]], np.float32)
FORD_T = np.array([1.0, 0.5, -1.4], np.float32)


def _extra(family):
    if family == "G2SP":
        return dict(camera_k=_scaled_default_k(Config(**GEOM["G2SP"])))
    if family == "Ford":
        return dict(ford_extrinsics=(FORD_R, FORD_T), ford_side_m=128 * 0.22)
    return {}


def _cfg_kw(family, **over):
    kw = dict(BASE, **GEOM[family], **over)
    if family == "G2SP":
        # the projective-line kernels sample a bf16 map (their only mode)
        kw["banded_bf16_map"] = 1
    return kw


def _jax_params(family, seed):
    g = GEOM[family]
    rng = np.random.RandomState(seed)
    sat = rng.rand(1, g["sat_size"], g["sat_size"], 3).astype(np.float32)
    grd = rng.rand(1, g["grd_h"], g["grd_w"], 3).astype(np.float32)
    net = JVGGUnet(level=3)
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(sat))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 100),
                                      jnp.asarray(grd))["params"],
            "damping": np.full((1, 3), 0.1 if family == "G2SP" else 0.0,
                               np.float32)}


def _images(family, seed, n):
    g = GEOM[family]
    rng = np.random.RandomState(seed)
    return (rng.rand(n, g["sat_size"], g["sat_size"], 3).astype(np.float32),
            rng.rand(n, g["grd_h"], g["grd_w"], 3).astype(np.float32))


def _metric(out):
    return np.stack([out["lateral_m"], out["longitudinal_m"],
                     out["heading_deg"]], -1)


def _rel_fro(got, want):
    """Relative Frobenius error of each [3, 3] covariance, the largest."""
    return float(max(np.linalg.norm(g - w) / np.linalg.norm(w)
                     for g, w in zip(got, want)))


# ------------------------------------------------------------- the solver

def _pieces(seed, flat=False):
    rng = np.random.RandomState(seed)
    B, H, W, C = 2, 4, 6, 3
    out, dx, dy, tgt = (rng.randn(B, H, W, C).astype(np.float32)
                        for _ in range(4))
    duv = rng.randn(B, H, W, 2, 3).astype(np.float32)
    if flat:  # no screen derivatives: H = 0, the Tikhonov floor bounds it
        dx[:] = 0.0
        dy[:] = 0.0
    mask = (rng.rand(1, H, W) > 0.3).astype(np.float32)
    return out, dx, dy, tgt, mask, duv


INFO_CASES = {"normalized": (True, (0, 1, 2), False),
              "unnormalized": (False, (0, 1, 2), False),
              "heading_frozen": (True, (0, 1), False),
              "flat": (True, (0, 1, 2), True)}


@pytest.mark.parametrize("case", list(INFO_CASES))
def test_information_and_covariance_match_jax(case):
    """``lm_information`` and ``pose_covariance`` on seeded random pieces,
    each output within 1e-5 relative (of its largest element) of JAX's;
    inactive DoFs have zero rows and columns; a flat residual gives the
    floor's large but finite covariance."""
    normalize, act, flat = INFO_CASES[case]
    p = _pieces(3, flat)
    got = tupd.lm_information(*(torch.from_numpy(a) for a in p), act,
                              normalize)
    want = jupd.lm_information(*(jnp.asarray(a) for a in p), act,
                               normalize=normalize)
    got = got + (tupd.pose_covariance(*got, act),)
    want = want + (jupd.pose_covariance(*want, act),)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    cov = got[-1].numpy()
    off = [i for i in range(3) if i not in act]
    assert (cov[:, off] == 0).all() and (cov[:, :, off] == 0).all()
    if flat:
        assert (got[0] == 0).all() and np.diagonal(cov, 0, 1, 2)[:, act]\
            .min() > 1e10


# ------------------------------------------------------- predict + cov

# Covariance limit, relative Frobenius per image, and the pose limit in m
# and deg.  H is inverted, so the frameworks' last-bit differences in the
# pose and the samples are amplified along H's weak direction; the inputs
# keep H well conditioned (condition number of the metric covariance
# below COND_MAX, checked; measured 55, 21 and 106).  Measured through
# predict: poses 9.5e-5 / 1.1e-5 / 2.4e-4, covariances 1.9e-5 / 6.2e-6 /
# 6.1e-6 (S2GP / G2SP / Ford); through the multi-start sweep: poses 8.6e-6
# / 6.3e-7 / 5.4e-5 normalized, covariances 2.8e-6 / 3.5e-6 / 3.8e-5.
COV_REL = 1e-3
POSE_ATOL = 1e-3
COND_MAX = 1e4


@pytest.mark.parametrize("family", list(GEOM))
def test_predict_return_cov_matches_jax(family):
    """``Localizer.predict(return_cov=True)`` against the JAX Localizer on
    the same params: poses within POSE_ATOL m and deg,
    the metric covariance, the uncalibrated warning, and ``cov_scale``."""
    kw = _cfg_kw(family)
    params = _jax_params(family, 20)
    sat, grd = _images(family, 21, 3)
    jloc = JLocalizer(JConfig(**kw, use_banded_warp=2), params=params,
                      batch_size=2, **_extra(family))
    want = jloc.predict(sat, grd, return_cov=True)
    tloc = Localizer(Config(**kw), params=params, batch_size=2,
                     device="cpu", **_extra(family))
    with pytest.warns(UserWarning, match="UNCALIBRATED"):
        got = tloc.predict(sat, grd, return_cov=True)
    assert got["cov"].shape == (3, 3, 3) and got["cov"].dtype == np.float32
    w = _metric(want)
    assert np.abs(w[:, :2]).max() < 2.5 * 20
    pose_err = np.abs(_metric(got) - w).max()
    cov_err = _rel_fro(got["cov"], want["cov"])
    cond = np.linalg.cond(want["cov"]).max()
    print(family, "pose", pose_err, "cov relFro", cov_err, "cond", cond)
    assert pose_err <= POSE_ATOL and cond < COND_MAX
    assert cov_err <= COV_REL
    np.testing.assert_allclose(got["cov"], got["cov"].transpose(0, 2, 1),
                               rtol=1e-5, atol=0)
    scaled = Localizer(Config(**kw), params=params, batch_size=2,
                       device="cpu", cov_scale=2.5, **_extra(family))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a calibrated Localizer is quiet
        out = scaled.predict(sat, grd, return_cov=True)
    np.testing.assert_array_equal(out["cov"], 2.5 * got["cov"])


def test_calibrate_matches_jax():
    """``calibrate`` on the same two S2GP batches with ground truth: the
    fitted scale within 1e-2 relative of JAX's (measured 1.2e-6); then
    ``predict`` uses it and emits no warning."""
    kw = _cfg_kw("S2GP")
    params = _jax_params("S2GP", 30)
    rng = np.random.RandomState(31)
    batches = []
    for b in range(2):
        sat, grd = _images("S2GP", 32 + b, 2)
        gt = np.stack([rng.uniform(-3, 3, 2), rng.uniform(-3, 3, 2),
                       rng.uniform(-2, 2, 2)], -1).astype(np.float32)
        batches.append(dict(sat=sat, grd=grd, gt_pose=gt))
    jloc = JLocalizer(JConfig(**kw, use_banded_warp=2), params=params,
                      batch_size=2)
    tloc = Localizer(Config(**kw), params=params, batch_size=2,
                     device="cpu")
    want = jloc.calibrate(batches)
    got = tloc.calibrate(batches)
    print("calibrate scale port", got, "JAX", want)
    assert np.isfinite(got) and got > 0 and tloc.cov_scale == got
    assert abs(got - want) <= 1e-2 * abs(want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tloc.predict(batches[0]["sat"], batches[0]["grd"],
                           return_cov=True)
    assert np.isfinite(out["cov"]).all()
    with pytest.raises(ValueError, match="empty"):
        tloc.calibrate([])


# -------------------------------------------------- the predict loop

def test_batched_predict_pads_to_the_smallest_size():
    """Chunks of the largest size; a tail goes to the smallest size that
    fits, padded with its last image; outputs and "cov" come back in
    order and unpadded."""
    seen = []

    def run(sb, gb, eb):
        seen.append((sb.shape[0], sb[:, 0, 0, 0].tolist()))
        v = sb[:, 0, 0, 0].astype(np.float32)
        return v, 2 * v, 3 * v, v[:, None, None] * np.ones((1, 3, 3))

    sat = np.arange(7, dtype=np.float32)[:, None, None, None] * np.ones(
        (1, 2, 2, 3), np.float32)
    out = _batched_predict(run, sat, sat, [1, 2, 4], (1.0, 1.0, 2.0), {},
                           with_cov=True)
    assert seen == [(4, [0, 1, 2, 3]), (4, [4, 5, 6, 6])]
    np.testing.assert_array_equal(out["lateral_m"], np.arange(7))
    np.testing.assert_array_equal(out["heading_deg"], 6 * np.arange(7))
    assert out["cov"].shape == (7, 3, 3)
    seen.clear()
    out = _batched_predict(run, sat[:5], sat[:5], [1, 2, 4], (1, 1, 1), {})
    assert [s for s, _ in seen] == [4, 1] and "cov" not in out
    seen.clear()
    _batched_predict(run, sat[:6], sat[:6], [1, 2, 4], (1, 1, 1), {})
    assert seen[1] == (2, [4, 5])
