"""Port parity for multi-start inference (``pose_hypotheses > 1``): each
family's sweep on the CPU against the JAX model on the same params and
inputs, and one hypothesis seeded with ``init_pose`` against the warm
single start.

The multi-start initial poses are fed to both: JAX draws them with
``jax.random.uniform`` from a key torch cannot reproduce, so the test
replaces that one (B, P, 3) draw inside the JAX call, and the port's
``draw_starts``, with the same numbers (the JAX package is unchanged).
Shapes, params and limits are those of tests/test_torch_serving_api.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.ford import LMS2GPFord as JFord
from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JG2SP
from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JS2GP
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models import lm_s2gp
from test_torch_serving_api import (COV_REL, FORD_R, FORD_T, GEOM,
                                    POSE_ATOL, _cfg_kw, _extra, _images,
                                    _jax_params, _rel_fro)

# The starts every test feeds both frameworks: hypothesis 0 is the zero
# (or warm) start, the others well apart in [-0.6, 0.6].
STARTS = np.array([[[0.0, 0.0, 0.0], [0.55, -0.45, 0.5],
                    [-0.5, 0.4, -0.6]],
                   [[0.0, 0.0, 0.0], [-0.45, -0.55, 0.3],
                    [0.6, 0.35, -0.4]]], np.float32)
JAX_FAMILY = {"S2GP": JS2GP, "G2SP": JG2SP, "Ford": JFord}


def _feed_starts(monkeypatch, starts):
    """Both frameworks' multi-start draw returns ``starts`` [B, P, 3]
    (rows repeated past the batch); the port's still consumes its numbers
    from the forward's generator."""
    uniform = jax.random.uniform
    draw = lm_s2gp.draw_starts

    def fixed(B, P):
        return np.resize(starts[:, :P], (B, P, 3)).astype(np.float32)

    def jax_uniform(key, shape=(), *a, **k):
        if len(shape) == 3 and shape[-1] == 3:
            return jnp.asarray(fixed(*shape[:2]))
        return uniform(key, shape, *a, **k)

    def port_draw(generator, B, P, device):
        draw(generator, B, P, device)
        return torch.from_numpy(fixed(B, P)).to(device)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(lm_s2gp, "draw_starts", port_draw)


def _model_inputs(family, n):
    sat, grd = _images(family, 40, n)
    if family == "G2SP":
        k = np.broadcast_to(_extra("G2SP")["camera_k"], (n, 3, 3))
        return sat, grd, (k.astype(np.float32),), {}
    if family == "Ford":
        return sat, grd, (np.broadcast_to(FORD_R, (n, 3, 3)).copy(),
                          np.broadcast_to(FORD_T, (n, 3)).copy()), {}
    return sat, grd, (), {}


def _port_call(model, family, sat, grd, extras, **kw):
    args = [torch.from_numpy(sat), torch.from_numpy(grd)]
    if family == "Ford":
        args.append(128 * 0.22)
    args += [torch.from_numpy(np.ascontiguousarray(e)) for e in extras]
    return model(*args, mode="test", **kw)


def _jax_call(model, family, params, sat, grd, extras, **kw):
    """The JAX model's test forward, jitted (its interpret-mode kernels
    run several times faster compiled than op by op)."""
    side = (128 * 0.22,) if family == "Ford" else ()

    def fwd(p, s, g, *ex):
        return model.apply({"params": p}, s, g, *side, *ex, mode="test",
                           rngs={"lm": jax.random.PRNGKey(4)}, **kw)

    return jax.jit(fwd)(params, jnp.asarray(sat), jnp.asarray(grd),
                        *(jnp.asarray(e) for e in extras))


def _port_model(family, params, **over):
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.params import state_dict_from_jax
    cls = {"S2GP": lm_s2gp.LMS2GP, "G2SP": LMG2SP, "Ford": LMS2GPFord}
    model = cls[family](Config(**_cfg_kw(family, **over)), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


@pytest.mark.parametrize("family", list(GEOM))
def test_multi_start_matches_jax(monkeypatch, family):
    """P = 3 hypotheses from the same starts: the port's final poses and
    costs of every hypothesis (``hypotheses``), its winner, and the JAX
    model's returned pose, which must be the port's winner (the nearest of
    its P finals, by far), within POSE_ATOL; the costs of the
    winner and the runner-up are well apart.  With ``with_info`` both
    append the winner's covariance."""
    _feed_starts(monkeypatch, STARTS)
    params = _jax_params(family, 50)
    sat, grd, extras, _ = _model_inputs(family, 2)
    model = _port_model(family, params, pose_hypotheses=3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        feats = model.extract_features(torch.from_numpy(sat),
                                       torch.from_numpy(grd))
        tex = [torch.from_numpy(np.ascontiguousarray(e)) for e in extras]
        if family == "G2SP":
            final, cost = model.hypotheses(feats[0], feats[2], tex[0], None,
                                           gen)
        else:
            geo = (model._geo(*tex, 128 * 0.22),) if family == "Ford" \
                else ()
            final, cost = model.hypotheses(feats[0], feats[2], None, gen,
                                           *geo)
    best = cost.argmin(1).numpy()
    srt = np.sort(cost.numpy(), 1)
    print(family, "costs", cost.numpy().tolist(), "winner", best)
    assert (srt[:, 1] - srt[:, 0] > 1e-3).all()
    got = _port_call(model, family, sat, grd, extras, with_info=True,
                     generator=torch.Generator().manual_seed(0))
    jmodel = JAX_FAMILY[family](cfg=JConfig(**_cfg_kw(
        family, pose_hypotheses=3), use_banded_warp=2))
    want = _jax_call(jmodel, family, params, sat, grd, extras,
                     with_info=True)
    order = [1, 0, 2] if family != "Ford" else [0, 1, 2]
    w = np.stack([np.asarray(x) for x in want[:3]], -1)[:, order]  # pose
    dist = np.abs(final.numpy() - w[:, None]).max(-1)             # [B, P]
    print(family, "JAX final vs port hypotheses", dist.tolist())
    np.testing.assert_array_equal(dist.argmin(1), best)
    # the limits in normalized units: ranges of 20 m, 20 m and 10 deg
    tol = POSE_ATOL / np.array([20.0, 20.0, 10.0], np.float32)
    assert (np.sort(dist, 1)[:, 1] > 10 * tol.max()).all()
    g = np.stack([x.numpy() for x in got[:3]], -1)
    err = np.abs(g - np.stack([np.asarray(x) for x in want[:3]], -1))
    print(family, "pose max |port - JAX| (normalized)", err.max(0))
    assert (err <= tol).all()
    np.testing.assert_allclose(g[:, order], final.numpy()[[0, 1], best],
                               rtol=0, atol=1e-6)
    assert got[3].shape == (2, 3, 3)
    print(family, "cov relFro", _rel_fro(got[3].numpy(), np.asarray(want[3])))
    assert _rel_fro(got[3].numpy(), np.asarray(want[3])) <= COV_REL


@pytest.mark.parametrize("family", list(GEOM))
def test_one_start_equals_warm_single(family):
    """One hypothesis seeded with ``init_pose`` is the warm single start
    (JAX ``test_multi_hypothesis_one_start_equals_warm_single``)."""
    params = _jax_params(family, 60)
    sat, grd, extras, _ = _model_inputs(family, 2)
    model = _port_model(family, params)
    init = torch.tensor([[0.3, -0.2, 0.1], [-0.4, 0.1, 0.0]])
    single = _port_call(model, family, sat, grd, extras, init_pose=init,
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        feats = model.extract_features(torch.from_numpy(sat),
                                       torch.from_numpy(grd))
        tex = [torch.from_numpy(np.ascontiguousarray(e)) for e in extras]
        gen = torch.Generator().manual_seed(1)
        if family == "G2SP":
            final, _ = model.hypotheses(feats[0], feats[2], tex[0], init,
                                        gen)
        else:
            geo = (model._geo(*tex, 128 * 0.22),) if family == "Ford" \
                else ()
            final, _ = model.hypotheses(feats[0], feats[2], init, gen, *geo)
    order = [1, 0, 2] if family != "Ford" else [0, 1, 2]
    np.testing.assert_allclose(final[:, 0].numpy()[:, order],
                               np.stack([s.numpy() for s in single], -1),
                               rtol=1e-6, atol=1e-6)
