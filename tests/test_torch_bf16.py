"""Port parity for bf16 features (``compute_dtype="bfloat16"``, the
``--test 1`` default of the KITTI CLI) against the JAX package at bf16
on the same weights and images (CPU; JAX with ``use_banded_warp=2``).

Flax's semantics on both sides: float32 parameters cast to bf16 with the
input at each conv, bf16 activations, pools, upsampling and confidence
heads, the feature norm taken in float32, the map bf16, the target rows
and the solver in float32.  Two bf16 convolutions of the same inputs agree
to about one bf16 rounding (2^-8 = 3.9e-3 relative), which then passes
through the pyramid; the limits:

* VGGUnet features and confidences: relL2 <= ``FEAT_REL_L2`` per level
  (measured 2.1e-3 to 4.1e-3);
* the round-1 pose of S2GP (K1's plain version) and G2SP (K4's): relL2
  <= ``POSE_REL_L2`` over the batch's poses (measured 5.3e-3 and 2.7e-3);
  the pose after all six rounds <= ``FINAL_POSE_REL_L2`` (measured 4.9e-2
  and 1.7e-3: the S2GP rounds amplify the feature differences, as they
  amplify last-bit differences of uv at float32);
* the float32 path is unchanged: a float32 model's features stay float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JLMG2SP
from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JLMS2GP
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
from highlyaccurate_tpu_torch.models.vggunet import VGGUnet
from highlyaccurate_tpu_torch.params import _branch, state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FEAT_REL_L2 = 1e-2
POSE_REL_L2 = 2e-2
FINAL_POSE_REL_L2 = 0.15

S2GP = dict(grd_h=32, grd_w=128, sat_size=64, level=3)
G2SP = dict(direction="G2SP", grd_h=64, grd_w=256, sat_size=128, level=3)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _images(kw, seed, n=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, kw["sat_size"], kw["sat_size"], 3).astype(np.float32),
            rng.rand(n, kw["grd_h"], kw["grd_w"], 3).astype(np.float32))


def _params(kw, seed):
    sat, grd = _images(kw, seed, n=1)
    net = JVGGUnet(level=3)
    g2sp = kw.get("direction") == "G2SP"
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(sat))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 1),
                                      jnp.asarray(grd))["params"],
            "damping": np.full((1, 3), 0.1 if g2sp else 0.0, np.float32)}


@pytest.mark.parametrize("hw", [(32, 128), (64, 64)])
def test_vggunet_bf16_matches_jax(hw):
    x = np.random.RandomState(hw[0]).rand(2, *hw, 3).astype(np.float32)
    jnet = JVGGUnet(level=3, dtype=jnp.bfloat16)
    params = jnet.init(jax.random.PRNGKey(hw[1]), jnp.asarray(x))["params"]
    want_f, want_c = jnet.apply({"params": params}, jnp.asarray(x))
    net = VGGUnet(3, torch.bfloat16)
    net.load_state_dict(_branch(params, ""))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        got_f, got_c = net(torch.from_numpy(x))
    for g, w in zip(got_f + got_c, list(want_f) + list(want_c)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        rel = _rel_l2(g.float().numpy(), np.asarray(w, np.float32))
        assert rel <= FEAT_REL_L2, rel
    # float32 stays float32
    with torch.no_grad():
        f32, _ = VGGUnet(3)(torch.from_numpy(x))
    assert all(f.dtype == torch.float32 for f in f32)


@pytest.mark.parametrize("family", ["S2GP", "G2SP"])
def test_pose_bf16_matches_jax(family):
    """Round 1 and the final round (N_iters 2 x 3 levels) of evaluation at
    bf16 features, on one init."""
    kw = dict(S2GP if family == "S2GP" else G2SP, N_iters=2,
              compute_dtype="bfloat16")
    params = _params(kw, seed=7)
    sat, grd = _images(kw, seed=8)
    if family == "S2GP":
        jmodel = JLMS2GP(cfg=JConfig(use_banded_warp=2, **kw))
        jargs = (jnp.asarray(sat), jnp.asarray(grd))
        model = LMS2GP(Config(**kw), device="cpu")
        extra, fwd = (), dict(generator=torch.Generator().manual_seed(0))
    else:
        from highlyaccurate_tpu_torch.models.lm_s2gp import _scaled_default_k
        k = np.broadcast_to(_scaled_default_k(Config(**kw)),
                            (2, 3, 3)).astype(np.float32)
        jmodel = JLMG2SP(cfg=JConfig(use_banded_warp=2, **kw))
        jargs = (jnp.asarray(sat), jnp.asarray(grd), jnp.asarray(k))
        model = LMG2SP(Config(**kw), device="cpu")
        extra, fwd = (torch.from_numpy(k),), {}
    want = np.stack([np.asarray(t) for t in jmodel.apply(
        {"params": params}, *jargs, mode="trajectory",
        rngs={"lm": jax.random.PRNGKey(0)})], -1)        # [B, I, L, 3]
    model.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = np.stack([t.numpy() for t in model(
            torch.from_numpy(sat), torch.from_numpy(grd), *extra,
            mode="trajectory", **fwd)], -1)
    assert np.abs(want[..., :2]).max() < 2.5  # no re-init draw
    first = _rel_l2(got[:, 0, 0], want[:, 0, 0])
    last = _rel_l2(got[:, -1, -1], want[:, -1, -1])
    print(family, "bf16 pose relL2: round 1", first, "final", last)
    assert first <= POSE_REL_L2 and last <= FINAL_POSE_REL_L2
