"""Port parity for the two correlation heads, S2GP ``orien_corr`` and
G2SP ``corr``, against the JAX package on the same weights
(``params.state_dict_from_jax``) and images, at the JAX tests' own shapes
(tests/test_model_s2gp.py:92, tests/test_model_g2sp_ford.py:75): a 32x128
ground input, a 64x64 satellite map, ``level=-1``; G2SP with
``shift_range_lat = shift_range_lon = 2.0`` so the search window fits.

Tolerances, and why:
* ``polar_grid``: bit for bit (the same numpy ops).
* ``polar_transform``: 1e-6 absolute on the same features (the gather
  sampler's sums in another order).
* ``soft_margin_triplet``: 1e-6 relative.
* test mode: the argmin estimates exactly equal; train mode: the loss
  within 1e-5 relative, and the gradients of both feature networks within
  relL2 ``GRAD_LIMIT`` (the two frameworks' convolutions differ by ~1e-6
  relative, and the steep exp(10 x) of the loss amplifies it; measured up
  to 5.7e-5).
* bf16 features: the JAX heads refuse them (``lax.conv_general_dilated``
  takes no mixed dtypes: the gather sampler promotes its output to
  float32, the other operand stays bf16); the port correlates in the
  promoted dtype.  The reference is the JAX head with the same promotion
  patched into its correlation for the test.  The bf16 rounding of
  features that differ by ~1e-6 between the frameworks moves the
  surfaces, so the loss is held within ``BF16_LOSS_REL`` and the argmin
  exactly (measured 3.7e-5 for ``orien_corr``, 2.5e-3 for ``corr``;
  the argmins equal).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.losses.losses import soft_margin_triplet as j_smt
from highlyaccurate_tpu.models.lm_g2sp import LMG2SP as JLMG2SP
from highlyaccurate_tpu.models.lm_s2gp import LMS2GP as JLMS2GP
from highlyaccurate_tpu.models.lm_s2gp import polar_grid as j_polar_grid
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.losses.losses import soft_margin_triplet
from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP, polar_grid
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=1, level=-1)
G2SP = dict(TINY, direction="G2SP", shift_range_lat=2.0, shift_range_lon=2.0)
B = 2
K = np.array([[582.9802 * 128 / 1024, 0.0, 496.2420 * 128 / 1024],
              [0.0, 482.7076 * 32 / 256, 125.0034 * 32 / 256],
              [0.0, 0.0, 1.0]], np.float32)
GRAD_LIMIT = 2e-4
BF16_LOSS_REL = 5e-3


def _data(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 64, 64, 3).astype(np.float32),
            rng.rand(B, 32, 128, 3).astype(np.float32),
            rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32))


@contextlib.contextmanager
def _promoting_conv():
    """The JAX heads with their correlation's operands promoted to one
    dtype (what the port does), for the bf16 reference."""
    conv = jax.lax.conv_general_dilated

    def promoted(x, k, *a, **kw):
        t = jnp.result_type(x, k)
        return conv(x.astype(t), k.astype(t), *a, **kw)

    with mock.patch.object(jax.lax, "conv_general_dilated", promoted):
        yield


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _branch_grads(sd_grads, prefix):
    keys = sorted(k for k in sd_grads if k.startswith(prefix))
    return np.concatenate([np.asarray(sd_grads[k]).ravel() for k in keys])


def _run_both(head, dtype):
    """JAX and the port on the same weights and images: (test output,
    loss, gradient of each branch) of each, as numpy."""
    g2sp = head == "corr"
    cfg = dict(G2SP if g2sp else TINY, compute_dtype=dtype)
    sat, grd, gt = _data(0 if g2sp else 7)
    kb = np.broadcast_to(K, (B, 3, 3)).copy()
    extra = (jnp.asarray(kb),) if g2sp else ()
    jmodel = (JLMG2SP if g2sp else JLMS2GP)(cfg=JConfig(**cfg))
    patch = (_promoting_conv() if dtype == "bfloat16"
             else contextlib.nullcontext())
    with patch:
        params = jax.jit(lambda key: jmodel.init(
            key, sat, grd, *extra, mode="test", method=head))(
            jax.random.PRNGKey(0))["params"]

        def loss_fn(p):
            return jmodel.apply({"params": p}, sat, grd, *extra, gt,
                                mode="train", method=head)

        def both(p):  # one program: a compile is most of the test's time
            return jax.value_and_grad(loss_fn)(p), jmodel.apply(
                {"params": p}, sat, grd, *extra, mode="test", method=head)

        (jloss, jgrads), jtest = jax.jit(both)(params)
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = (LMG2SP if g2sp else LMS2GP)(Config(**cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    ts = [torch.from_numpy(a) for a in (sat, grd)]
    textra = (torch.from_numpy(kb),) if g2sp else ()
    fn = getattr(model, head)
    loss = fn(*ts, *textra, torch.from_numpy(gt), mode="train")
    loss.backward()
    # a parameter the head never reads keeps grad None (JAX: zeros)
    tgrads = {k: (np.zeros(p.shape, np.float32) if p.grad is None
                  else p.grad.numpy()) for k, p in model.named_parameters()}
    with torch.no_grad():
        ttest = fn(*ts, *textra, mode="test")

    def result(test, lss, grads):
        return dict(test=[np.asarray(t) for t in
                          (test if g2sp else (test,))],
                    loss=float(lss),
                    grads={br: _branch_grads(grads, br) for br in
                           ("SatFeatureNet.", "GrdFeatureNet.")})

    out = {"jax": result(jtest, jloss, jgrads),
           "port": result(ttest, loss.detach(), tgrads)}
    return out


@pytest.fixture(scope="module", params=["orien_corr", "corr"])
def head_f32(request):
    return request.param, _run_both(request.param, "float32")


@pytest.mark.parametrize("sat_size,slot", [(64, 0), (64, 2), (512, 1),
                                           (512, 3), (256, 2)])
def test_polar_grid_bit_for_bit(sat_size, slot):
    np.testing.assert_array_equal(polar_grid(sat_size, slot),
                                  j_polar_grid(sat_size, slot))


def test_polar_transform():
    """``polar_transform`` of the same features, at every slot of a
    level-3 model: [B, A/2, 8A, C] within 1e-6."""
    cfg = dict(TINY, level=3)
    jmodel = JLMS2GP(cfg=JConfig(**cfg))
    model = LMS2GP(Config(**cfg), device="cpu")
    rng = np.random.RandomState(3)
    for slot in model._slots:
        A = 64 >> (3 - slot)
        feat = rng.randn(B, A, A, 5).astype(np.float32)
        want = jmodel.apply({"params": {"damping": jnp.zeros((1, 3))}},
                            jnp.asarray(feat), slot,
                            method="polar_transform")
        got = model.polar_transform(torch.from_numpy(feat), slot)
        assert got.shape == (B, A // 2, 8 * A, 5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_soft_margin_triplet():
    """Same corr and cells, the last ones out of range and negative (a
    JAX gather clamps them, and counts a negative index from the end)."""
    rng = np.random.RandomState(4)
    corr = rng.randn(4, 5, 7).astype(np.float32)
    u = np.array([0.0, 6.7, 9.0, -1.0], np.float32)
    v = np.array([4.2, 0.0, 2.0, -2.0], np.float32)
    want = float(j_smt(jnp.asarray(corr), jnp.asarray(u), jnp.asarray(v)))
    got = float(soft_margin_triplet(*(torch.from_numpy(a)
                                      for a in (corr, u, v))))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_head_argmin_equal(head_f32):
    head, out = head_f32
    for g, w in zip(out["port"]["test"], out["jax"]["test"]):
        print(head, "test output port / JAX:", g, w)
        np.testing.assert_array_equal(g, w)


def test_head_train_loss(head_f32):
    head, out = head_f32
    got, want = out["port"]["loss"], out["jax"]["loss"]
    print(head, "loss port / JAX:", got, want)
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)


def test_head_gradients(head_f32):
    """Both feature networks get a gradient, within ``GRAD_LIMIT``."""
    head, out = head_f32
    for br, want in out["jax"]["grads"].items():
        got = out["port"]["grads"][br]
        assert got.shape == want.shape and np.abs(want).max() > 0, br
        err = _rel_l2(got, want)
        print(head, br, "relL2:", err)
        assert err <= GRAD_LIMIT, br


@pytest.mark.parametrize("head", ["orien_corr", "corr"])
def test_head_bf16_features(head):
    out = _run_both(head, "bfloat16")
    got, want = out["port"]["loss"], out["jax"]["loss"]
    print(head, "bf16 loss port / JAX:", got, want)
    assert abs(got - want) <= BF16_LOSS_REL * abs(want)
    for g, w in zip(out["port"]["test"], out["jax"]["test"]):
        np.testing.assert_array_equal(g, w)
    for br, w in out["jax"]["grads"].items():
        assert np.isfinite(out["port"]["grads"][br]).all(), br
        assert np.abs(out["port"]["grads"][br]).max() > 0, br
