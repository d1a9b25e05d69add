"""``Localizer.export`` and ``ExportedLocalizer`` on the CPU: an artifact
serves the same outputs as the live ``Localizer`` it came from (KITTI
S2GP with batch sizes [1, 2], G2SP, Ford, S2GP with ``warm_start`` and
``return_cov``, with ``dropout`` and with ``Optimizer="NN"``, G2SP with
``proj="nn"`` and Ford with ``estimate_depth``), that an export leaves
later live answers as they were, and it
refuses what it cannot serve: another format (a
JAX artifact included), another device type, ``init_pose`` without
``warm_start``, and a Ford rig of the other kernel layout.  On the card
the ``serving_api`` phase of chip_smoke.py checks that an exported
program launches the hand kernels."""

import json
import zipfile

import numpy as np
import pytest

from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.inference import ExportedLocalizer, Localizer
from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# one pyramid level, one round: a short program to trace (the contract
# under test does not depend on the depth)
S2GP = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=1, level=-1)
WIDE = dict(grd_h=64, grd_w=256, sat_size=128, N_iters=1, level=-1)
FORD_R = np.array([[0.995, -0.04, 0.09], [0.05, 0.997, -0.06],
                   [-0.087, 0.064, 0.994]], np.float32)
FORD_T = np.array([1.0, 0.5, -1.4], np.float32)
# name: (config, Localizer kwargs, export kwargs)
CASES = {
    "s2gp_sizes": (S2GP, {}, dict(batch_sizes=[1, 2])),
    "g2sp": (dict(WIDE, direction="G2SP"),
             dict(camera_k=_scaled_default_k(Config(**WIDE))), {}),
    "ford": (WIDE, dict(ford_extrinsics=(FORD_R, FORD_T),
                        ford_side_m=128 * 0.22), {}),
    "warm_cov": (S2GP, {}, dict(warm_start=True, return_cov=True)),
    # the solver options' draws: a dropout keep-set per round for the
    # batch (an input of the program), and NN's head, which draws nothing
    "dropout": (dict(S2GP, dropout=1), {}, {}),
    "nn": (dict(S2GP, Optimizer="NN"), {}, {}),
    # the projection and depth options export as JAX's do: G2SP nn (the
    # re-laid-out ground branch, the in-plane warp) and Ford's estimated
    # depth (the depth heads, the lifted rays), both on the gather sampler
    "g2sp_nn": (dict(WIDE, direction="G2SP", proj="nn"),
                dict(camera_k=_scaled_default_k(Config(**WIDE))), {}),
    "ford_depth": (dict(WIDE, estimate_depth=1),
                   dict(ford_extrinsics=(FORD_R, FORD_T),
                        ford_side_m=128 * 0.22), {}),
}


def _localizer(name):
    cfg, kw, _ = CASES[name]
    return Localizer(Config(**cfg), random_init=True, batch_size=2, seed=3,
                     device="cpu", **kw)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for name, (_, _, exp) in CASES.items():
        paths[name] = str(root / f"{name}.zip")
        _localizer(name).export(paths[name], **exp)
    return paths


def _images(cfg, n, seed):
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, cfg["sat_size"], cfg["sat_size"], 3) * 255)
            .astype(np.uint8),
            rng.rand(n, cfg["grd_h"], cfg["grd_w"], 3).astype(np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_exported_serves_like_live(artifacts, name):
    """Three images (one full batch of 2 and a tail of 1; with sizes
    [1, 2] the tail runs the batch-1 program) through a fresh live
    ``Localizer`` and the artifact, both seeded alike: every output within
    1e-6 (m, deg; measured 0 throughout)."""
    cfg, _, exp = CASES[name]
    srv = ExportedLocalizer(artifacts[name], seed=3, device="cpu")
    assert srv.batch_sizes == exp.get("batch_sizes", [2])
    loc = _localizer(name)
    sat, grd = _images(cfg, 3, 5)
    calls = [{}]
    if exp.get("warm_start"):
        calls.append(dict(init_pose=np.array(
            [[0.5, -1.0, 0.3], [1.0, 0.2, -0.4], [-0.6, 0.7, 0.1]],
            np.float32)))
    for kw in calls:
        want = loc.predict(sat, grd, return_cov=exp.get("return_cov", False),
                           **kw)
        got = srv.predict(sat, grd, **kw)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and np.isfinite(got[k]).all()
            err = float(np.abs(got[k] - v).max())
            print(name, k, "max |exported - live|:", err)
            assert err <= 1e-6 * max(1.0, float(np.abs(v).max())), k
    meta = srv.meta
    assert meta["device"] == "cpu"
    assert meta["ford"] == (name in ("ford", "ford_depth"))
    assert meta["g2sp"] == (name in ("g2sp", "g2sp_nn"))
    assert meta["draws_per_image"] == (
        0 if name in ("g2sp", "g2sp_nn", "nn") else 2)
    # dropout: one number per kept pixel of the 4 x 16 level's 2 kept rows
    assert meta["draws_per_batch"] == (32 if name == "dropout" else 0)


def test_exported_refusals(artifacts, tmp_path):
    """A JAX artifact and a wrong device type refuse to load; init_pose
    without warm_start and a Ford rig of the other layout refuse to
    serve."""
    jax_art = tmp_path / "jax.zip"
    with zipfile.ZipFile(jax_art, "w") as z:
        z.writestr("meta.json", json.dumps(
            {"format": "highlyaccurate_tpu.localizer/1", "batch_size": 2}))
        z.writestr("program.jaxexport", b"")
    with pytest.raises(ValueError, match="not a highlyaccurate_tpu_torch"):
        ExportedLocalizer(str(jax_art), device="cpu")

    cuda_art = tmp_path / "cuda.zip"
    with zipfile.ZipFile(artifacts["s2gp_sizes"]) as src, \
            zipfile.ZipFile(cuda_art, "w") as dst:
        for item in src.namelist():
            data = src.read(item)
            if item == "meta.json":
                meta = json.loads(data)
                meta["device"] = "cuda"
                data = json.dumps(meta)
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        ExportedLocalizer(str(cuda_art), device="cpu")

    srv = ExportedLocalizer(artifacts["s2gp_sizes"], device="cpu")
    sat, grd = _images(S2GP, 1, 6)
    with pytest.raises(ValueError, match="warm_start"):
        srv.predict(sat, grd, init_pose=np.zeros((1, 3), np.float32))

    srv = ExportedLocalizer(artifacts["ford"], device="cpu")
    assert srv.meta["ford_layout"] is True
    sat, grd = _images(WIDE, 1, 7)
    # camera x axis along body east: the rows run along sat u
    turned = np.array([[[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                        [0.0, 0.0, 1.0]]], np.float32)
    with pytest.raises(ValueError, match="other banded kernel layout"):
        srv.predict(sat, grd, R_FL=turned, T_FL=FORD_T[None])


@pytest.mark.parametrize("name", ["g2sp_nn", "s2gp_sizes"])
def test_export_then_live_is_order_free(tmp_path, name):
    """A live answer does not depend on an export earlier in the process:
    live, export, live again, each live ``Localizer`` fresh and seeded
    alike, bit for bit (a cache that kept a tensor made while the export
    traced once turned every later G2SP nn answer into the zero pose)."""
    cfg, _, exp = CASES[name]
    sat, grd = _images(cfg, 3, 5)
    first = _localizer(name).predict(sat, grd)
    assert max(float(np.abs(v).max()) for v in first.values()) > 1e-3
    _localizer(name).export(str(tmp_path / "a.zip"), **exp)
    again = _localizer(name).predict(sat, grd)
    assert sorted(again) == sorted(first)
    for k, v in first.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
