"""The plain reference agrees with the port on the CPU at a tiny shape:
the same weights and frames give the same trajectory of poses, and a
training step the same loss and gradients."""

import numpy as np
import pytest
import torch

from benchmark.reference import g2sp, s2gp

SIZES = dict(sat_size=128, grd_h=64, grd_w=256, N_iters=2,
             shift_range_lat=20.0, shift_range_lon=20.0,
             rotation_range=10.0, damping=0.1, banded_bf16_map=1,
             g2sp_restrict_grid=1)


def port_model(direction, **kw):
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    from highlyaccurate_tpu_torch.params import init_params
    cfg = Config(direction=direction, grd_h=64, grd_w=256, sat_size=128,
                 N_iters=2, **kw)
    m = (LMG2SP if direction == "G2SP" else LMS2GP)(cfg, device="cpu")
    init_params(m, torch.Generator().manual_seed(0))
    return m, {k: v.detach().clone() for k, v in m.state_dict().items()}


def images(B=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, 128, 128, 3, generator=g),
            torch.rand(B, 64, 256, 3, generator=g))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,banded,rule,tol", [
    ("bfloat16", 1, "line", 1e-4), ("float32", 1, "line", 1e-4),
    ("float32", 0, "gather", 1e-5)])
def test_s2gp_trajectory_matches_the_port(dtype, banded, rule, tol):
    m, sd = port_model("S2GP", compute_dtype=dtype, use_banded_warp=banded)
    sat, grd = images()
    with torch.no_grad():
        lat, lon, th = m(sat, grd, mode="trajectory",
                         generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    draws = [torch.rand((2, 3), generator=gen) * 2 - 1 for _ in range(6)]
    with torch.no_grad():
        ref = s2gp.trajectory(sd, sat, grd, SIZES, lambda t: draws[t],
                              dtype, rule)
    assert (torch.stack([lon, lat, th], -1) - ref).abs().max() < tol


def test_g2sp_trajectory_matches_the_port():
    m, sd = port_model("G2SP", compute_dtype="bfloat16")
    sat, grd = images()
    k = torch.from_numpy(g2sp.DEFAULT_K * np.array(
        [[0.25], [0.25], [1.0]], np.float32)).expand(3, 3, 3)
    with torch.no_grad():
        lat, lon, th = m(sat, grd, k, mode="trajectory")
        ref = g2sp.trajectory(sd, sat, grd, SIZES, None, "bfloat16")
    assert (torch.stack([lon, lat, th], -1) - ref).abs().max() < 1e-4


def test_s2gp_training_gradients_match_the_port():
    m, sd = port_model("S2GP", compute_dtype="float32", test=0)
    m.train()
    sat, grd = images(4)
    gt = torch.rand(4, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    out = m(sat, grd, mode="train", gt_pose=gt,
            generator=torch.Generator().manual_seed(5))
    out.loss.backward()
    theta = {k: v.requires_grad_(True) for k, v in sd.items()}
    gen = torch.Generator().manual_seed(5)
    draws = [torch.rand((2, 4), generator=gen) * 2 - 1 for _ in range(6)]
    loss = s2gp.loss(s2gp.trajectory(theta, sat, grd, SIZES,
                                     lambda t: draws[t], "float32", "line"),
                     gt).mean()
    loss.backward()
    assert abs(loss.item() - out.loss.item()) < 1e-4 * out.loss.item()
    for name, p in m.named_parameters():
        ref = theta[name].grad
        assert (p.grad is None) == (ref is None), name
        if ref is not None:
            assert (p.grad - ref).norm() <= 0.05 * ref.norm(), name
