"""Port parity for the serving API and the port's package rules:
``Localizer.predict`` (S2GP) on the CPU against the JAX ``Localizer`` on the
same params; the port imports nothing of JAX; options the port does not
carry raise ``NotImplementedError``; with no GPU, the default device
raises.  The G2SP ``Localizer`` is in tests/test_torch_lm_g2sp.py."""

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


UNSUPPORTED = [
    # G2SP at TINY's 32-row ground input: the coarse level's ground map is
    # 4 rows, which needs the gather sampler (tests/test_torch_lm_g2sp.py
    # has the G2SP options)
    dict(direction="G2SP"), dict(proj="polar"), dict(Optimizer="SGD"),
    dict(using_weight=1), dict(use_gt_depth=1), dict(dropout=2),
    dict(level_first=1), dict(pose_hypotheses=4), dict(use_fused_moments=0),
    dict(use_banded_warp=0), dict(compute_dtype="bfloat16"),
]


@pytest.mark.parametrize("opt", UNSUPPORTED,
                         ids=[next(iter(o)) for o in UNSUPPORTED])
def test_unsupported_options_raise(opt):
    from highlyaccurate_tpu_torch.inference import Localizer
    name = next(iter(opt))
    with pytest.raises(NotImplementedError, match=name):
        Localizer(Config(**TINY, **opt), random_init=True, device="cpu")


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
    with pytest.raises(NotImplementedError, match="return_cov"):
        loc.predict(sat, grd, return_cov=True)
    # loss_method 1-3 still serve, as in JAX; training refuses them
    loc = Localizer(Config(**TINY, loss_method=1), random_init=True,
                    device="cpu")
    loc.predict(sat, grd)
    with pytest.raises(NotImplementedError, match="loss_method"):
        loc.model(torch.from_numpy(sat), torch.from_numpy(grd), mode="train",
                  gt_pose=torch.zeros(1, 3), generator=torch.Generator())


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from highlyaccurate_tpu_torch.inference import Localizer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Localizer(Config(**TINY), random_init=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMS2GP(Config(**TINY), device="cuda")
