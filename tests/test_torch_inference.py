"""Port parity for the serving API and the port's package rules:
``Localizer.predict`` (S2GP) on the CPU against the JAX ``Localizer`` on the
same params; the port imports nothing of JAX; options the port does not
carry raise ``NotImplementedError``; with no GPU, the default device
raises.  The G2SP ``Localizer`` is in tests/test_torch_lm_g2sp.py; the
covariance, multi-start and export in tests/test_torch_serving_api.py and
tests/test_torch_export.py."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=2, level=3)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _images(seed, n=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 64, 64, 3).astype(np.float32),
            rng.rand(n, 32, 128, 3).astype(np.float32))


def _jax_params(seed):
    """A JAX LMS2GP params pytree: two initialised VGGUnet branches and a
    zero damping, as LMS2GP.init creates them."""
    sat, grd = _images(seed, n=1)
    net = JVGGUnet(level=TINY["level"])
    return {
        "SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                  jnp.asarray(sat))["params"],
        "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 100),
                                  jnp.asarray(grd))["params"],
        "damping": np.zeros((1, 3), np.float32),
    }


def test_localizer_matches_jax():
    """Localizer.predict on CPU against the JAX Localizer on the same
    params: metric outputs, a ragged tail padded, uint8 input and a warm
    start.  fp32 map, one iteration, so atol 1e-4 m / deg holds (1e-5 in
    normalized pose, times the 20 m / 10 deg ranges, with margin)."""
    from highlyaccurate_tpu.inference import Localizer as JLocalizer
    from highlyaccurate_tpu_torch.inference import Localizer

    kw = dict(TINY, N_iters=1, banded_bf16_map=0)
    params = _jax_params(6)
    rng = np.random.RandomState(7)
    sat = (rng.rand(3, 64, 64, 3) * 255).astype(np.uint8)
    grd = rng.rand(3, 32, 128, 3).astype(np.float32)
    init = {"lateral_m": rng.uniform(-2, 2, 3).astype(np.float32),
            "longitudinal_m": rng.uniform(-2, 2, 3).astype(np.float32),
            "heading_deg": rng.uniform(-1, 1, 3).astype(np.float32)}
    jloc = JLocalizer(JConfig(use_banded_warp=2, **kw), params=params,
                      batch_size=2)
    tloc = Localizer(Config(**kw), params=params, batch_size=2, device="cpu")
    for init_pose in (None, init):
        want = jloc.predict(sat, grd, init_pose=init_pose)
        got = tloc.predict(sat, grd, init_pose=init_pose)
        assert np.all(np.abs(want["lateral_m"]) < 2.5 * 20)
        for k in ("lateral_m", "longitudinal_m", "heading_deg"):
            assert got[k].shape == (3,) and got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0,
                                       err_msg=k)
    empty = tloc.predict(sat[:0], grd[:0])
    assert all(v.shape == (0,) for v in empty.values())


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "highlyaccurate_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "highlyaccurate_tpu"), f"{f}: imports {mod}"


UNSUPPORTED = [dict(proj="polar"), dict(use_gt_depth=1)]


@pytest.mark.parametrize("opt", UNSUPPORTED,
                         ids=[next(iter(o)) for o in UNSUPPORTED])
def test_unsupported_options_raise(opt):
    from highlyaccurate_tpu_torch.inference import Localizer
    name = next(iter(opt))
    with pytest.raises(NotImplementedError, match=name):
        Localizer(Config(**TINY, **opt), random_init=True, device="cpu")


# Options the port serves since the gather path came (they were refused
# before), each ``Localizer.predict`` against the JAX Localizer on one
# init at TINY's sizes, one iteration:
# * G2SP at TINY's 32-row ground input, whose coarse ground map (4 rows)
#   takes the gather sampler and the other two levels the projective-line
#   kernels (JAX ``use_banded_warp=2``);
# * S2GP with ``use_fused_moments=0`` (K2 and ``lm_update_implicit``,
#   fp32 map, JAX ``use_banded_warp=2``) and with ``use_banded_warp=0``
#   (the gather sampler on both sides);
# * Ford at bf16 features (JAX ``use_banded_warp=2``);
# * S2GP with ``pose_hypotheses=4`` (fp32 map, JAX ``use_banded_warp=2``),
#   both frameworks fed the same starts (``_feed_starts``);
# * the solver options (fp32 map, JAX ``use_banded_warp=2``):
#   ``Optimizer="SGD"`` (K2's samples and the materialized Jacobian),
#   ``using_weight`` (the gather sampler, the confidence weight),
#   ``dropout`` (K2 and ``lm_update_implicit``; both frameworks keep the
#   same pixels, ``_feed_keep``) and ``level_first``, at N_iters=2 so the
#   order matters (measured 1.4e-6, 1.4e-6, 1.2e-4 and 6.6e-5 m, deg).
# atol 1e-3 m / deg as above (measured 5.3e-5, 3.8e-6 and 5.1e-5), except
# where a
# bf16 map or bf16 features enter: G2SP's projective-line levels sample a
# bf16 copy of each framework's own ground map, whose rounding flips where
# the two convolutions differ in the last bits, so atol 5e-2 m / deg
# (2.5e-3 of the 20 m range; measured 1.7e-2; KITTI S2GP's bf16 map reads
# 4.4e-3 normalized over 6 rounds, ROADMAP C); bf16 features: relL2 over
# the outputs <= 0.15, the final-pose limit of tests/test_torch_bf16.py
# (measured 4.5e-2).
LIFTED = {
    "direction": (dict(direction="G2SP"), dict(use_banded_warp=2)),
    "use_fused_moments": (dict(use_fused_moments=0, banded_bf16_map=0),
                          dict(use_banded_warp=2)),
    "use_banded_warp": (dict(use_banded_warp=0), {}),
    "compute_dtype": (dict(compute_dtype="bfloat16"),
                      dict(use_banded_warp=2)),
    "pose_hypotheses": (dict(pose_hypotheses=4, banded_bf16_map=0),
                        dict(use_banded_warp=2)),
    "Optimizer": (dict(Optimizer="SGD", banded_bf16_map=0),
                  dict(use_banded_warp=2)),
    "using_weight": (dict(using_weight=1, banded_bf16_map=0),
                     dict(use_banded_warp=2)),
    "dropout": (dict(dropout=1, banded_bf16_map=0), dict(use_banded_warp=2)),
    "level_first": (dict(level_first=1, N_iters=2, banded_bf16_map=0),
                    dict(use_banded_warp=2)),
}
# the multi-start initial poses of one batch of 2 [2, 4, 3]; hypothesis 0
# is the zero start in both frameworks
STARTS = np.array([[[0.0, 0.0, 0.0], [0.5, -0.4, 0.5], [-0.5, 0.4, -0.6],
                    [0.3, 0.55, 0.2]],
                   [[0.0, 0.0, 0.0], [-0.4, -0.5, 0.3], [0.6, 0.3, -0.4],
                    [-0.2, 0.45, 0.6]]], np.float32)


def _feed_starts(monkeypatch):
    """JAX's (B, P, 3) start draw and the port's ``draw_starts`` both
    return STARTS (the port's still consumes its generator's numbers)."""
    from highlyaccurate_tpu_torch.models import lm_s2gp
    uniform, draw = jax.random.uniform, lm_s2gp.draw_starts

    def jax_uniform(key, shape=(), *a, **k):
        if len(shape) == 3 and shape[-1] == 3:
            return jnp.asarray(STARTS[:shape[0], :shape[1]])
        return uniform(key, shape, *a, **k)

    def port_draw(generator, B, P, device):
        draw(generator, B, P, device)
        return torch.from_numpy(STARTS[:B, :P]).to(device)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(lm_s2gp, "draw_starts", port_draw)


def _feed_keep(monkeypatch):
    """JAX's dropout permutation and the port's ``dropout_keep`` keep the
    same fixed pixels (the first half of one numpy permutation of each
    length; the port's still consumes its generator's numbers)."""
    from highlyaccurate_tpu_torch.solver import updates
    keep = updates.dropout_keep
    perms = {}

    def perm(n):
        if n not in perms:
            perms[n] = np.random.RandomState(n).permutation(n)
        return perms[n]

    def port_keep(generator, H, W, device):
        keep(generator, H, W, device)
        return torch.from_numpy(perm(H * W)[:H * W // 2]).to(device)

    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.asarray(perm(n)))
    monkeypatch.setattr(updates, "dropout_keep", port_keep)


@pytest.mark.parametrize("name", list(LIFTED))
def test_lifted_options_serve_like_jax(name, monkeypatch):
    from highlyaccurate_tpu.inference import Localizer as JLocalizer
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k

    kw, jax_kw = LIFTED[name]
    kw = dict(dict(TINY, N_iters=1), **kw)
    params = _jax_params(10)
    if name == "direction":
        params["damping"] = np.full((1, 3), 0.1, np.float32)
    extra = {}
    if name == "direction":
        extra = dict(camera_k=_scaled_default_k(Config(**kw)))
    elif name == "compute_dtype":
        R = np.array([[0.995, -0.04, 0.09], [0.05, 0.997, -0.06],
                      [-0.087, 0.064, 0.994]], np.float32)
        extra = dict(ford_extrinsics=(R, np.array([1.0, 0.5, -1.4],
                                                  np.float32)),
                     ford_side_m=64 * 0.22)
    if name == "pose_hypotheses":
        _feed_starts(monkeypatch)
    if name == "dropout":
        _feed_keep(monkeypatch)
    sat, grd = _images(11, n=3)
    want = JLocalizer(JConfig(**kw, **jax_kw), params=params, batch_size=2,
                      **extra).predict(sat, grd)
    got = Localizer(Config(**kw), params=params, batch_size=2, device="cpu",
                    **extra).predict(sat, grd)
    keys = ("lateral_m", "longitudinal_m", "heading_deg")
    g = np.stack([got[k] for k in keys], -1)
    w = np.stack([want[k] for k in keys], -1)
    assert g.shape == (3, 3) and np.isfinite(g).all()
    assert np.abs(w[:, :2]).max() < 2.5 * 20 and np.abs(w).max() > 1e-2
    print(name, "max |port - JAX|:", np.abs(g - w).max())
    if name == "compute_dtype":
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 0.15
    else:
        np.testing.assert_allclose(
            g, w, atol=5e-2 if name == "direction" else 1e-3, rtol=0)


def test_unsupported_entry_options_raise():
    from highlyaccurate_tpu_torch.inference import Localizer
    with pytest.raises(NotImplementedError, match="save_path"):
        Localizer(Config(**TINY), save_path="ckpt", device="cpu")
    # Ford needs both of its inputs (tests/test_torch_ford.py serves it)
    with pytest.raises(ValueError, match="Ford serving needs both"):
        Localizer(Config(**TINY), random_init=True, device="cpu",
                  ford_side_m=100.)
    loc = Localizer(Config(**TINY), random_init=True, device="cpu")
    sat, grd = _images(0, n=1)
    with pytest.warns(UserWarning, match="UNCALIBRATED"):
        out = loc.predict(sat, grd, return_cov=True)
    assert out["cov"].shape == (1, 3, 3) and np.isfinite(out["cov"]).all()
    # loss_method 1-3 serve as method 0 does and train with their terms
    # (tests/test_torch_solver_train.py holds them to JAX)
    loc = Localizer(Config(**TINY, loss_method=1), random_init=True,
                    device="cpu")
    loc.predict(sat, grd)
    out = loc.model(torch.from_numpy(sat), torch.from_numpy(grd),
                    mode="train", gt_pose=torch.full((1, 3), 0.5),
                    generator=torch.Generator())
    assert out.L1 is not None and torch.isfinite(out.loss)
    # the covariance of a weighted solve is refused, as in JAX; an
    # Optimizer KITTI S2GP has no rule for raises ValueError
    loc = Localizer(Config(**TINY, using_weight=1), random_init=True,
                    device="cpu")
    with pytest.raises(ValueError, match="using_weight"):
        loc.predict(sat, grd, return_cov=True)
    with pytest.raises(ValueError, match="unknown Optimizer GN"):
        Localizer(Config(**TINY, Optimizer="GN"), random_init=True,
                  device="cpu")


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from highlyaccurate_tpu_torch.inference import Localizer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Localizer(Config(**TINY), random_init=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMS2GP(Config(**TINY), device="cuda")
