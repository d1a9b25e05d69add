"""Port parity for the solver options' building blocks on the CPU: the
update rules (``lm_update`` with the confidence weight and the dropout
keep-set, the implicit updates with the keep-set as a mask, ``sgd_update``,
``adam_update``, ``gn_update``, ``sgd_update_l1``), the ``NNrefine`` head
and its params importer, and loss methods 1-3, each against the JAX
package on the same seeded inputs.

The random numbers are fed to both.  JAX draws the keep-set with
``jax.random.permutation(dropout_key, H * W)`` and the re-init with two
``uniform`` draws from the re-init key; the test computes those from the
keys it passes and hands the port numbers whose argsort is that
permutation (``dropout_keep`` keeps the indices of the smallest half),
then the same two uniform draws (``PresetDraws``).

Limits: every output within 1e-5 of its largest element (measured in the
comments), float32 reassociation only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.losses import losses as jl
from highlyaccurate_tpu.models.nnrefine import NNrefine as JNNrefine
from highlyaccurate_tpu.solver import updates as ju
from highlyaccurate_tpu_torch.losses import losses as tl
from highlyaccurate_tpu_torch.models.nnrefine import NNrefine
from highlyaccurate_tpu_torch.params import _nnrefine, init_params
from highlyaccurate_tpu_torch.solver import updates as tu
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
B, H, W, C = 2, 6, 5, 4


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    print(what, "max |port - JAX| / max", err / scale)
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _system(seed):
    """sat, grd, conf [B, H, W, 1] in (0, 1], jac [B, H, W, C, 3]."""
    rng = np.random.RandomState(seed)
    sat = rng.randn(B, H, W, C).astype(np.float32)
    grd = rng.randn(B, H, W, C).astype(np.float32)
    conf = rng.uniform(0.1, 1.0, (B, H, W, 1)).astype(np.float32)
    jac = rng.randn(B, H, W, C, 3).astype(np.float32) * 0.1
    pose = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    return pose, sat, grd, conf, jac


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _keep_numbers(key, hw):
    """Numbers whose argsort is ``jax.random.permutation(key, hw)``."""
    perm = np.asarray(jax.random.permutation(key, hw))
    nums = np.empty(hw, np.float32)
    nums[perm] = np.linspace(-1.0, 1.0, hw, endpoint=False)
    return nums


def _reinit_numbers(key, n):
    """JAX ``_solve_and_reinit``'s two uniform draws [u..., v...]."""
    k1, k2 = jax.random.split(key)
    return np.concatenate([np.asarray(jax.random.uniform(
        k, (n,), minval=-1.0, maxval=1.0)) for k in (k1, k2)])


def _lm_draws(key, hw, n, dropout=True):
    """The port's numbers for one JAX LM update under ``key``: the
    keep-set's (with ``dropout``), then the re-init's."""
    dkey, rkey = jax.random.split(key)
    keep = [_keep_numbers(dkey, hw)] if dropout else []
    return tu.PresetDraws(torch.from_numpy(np.concatenate(
        keep + [_reinit_numbers(rkey, n)])))


def test_dropout_keep_is_the_permutations_first_half():
    key = jax.random.PRNGKey(7)
    perm = np.asarray(jax.random.permutation(key, H * W))
    keep = tu.dropout_keep(tu.PresetDraws(torch.from_numpy(
        _keep_numbers(key, H * W))), H, W, "cpu")
    np.testing.assert_array_equal(keep.numpy(), perm[:H * W // 2])
    mask = tu.dropout_mask(tu.PresetDraws(torch.from_numpy(
        _keep_numbers(key, H * W))), H, W, "cpu")
    assert mask.sum() == H * W // 2
    # a generator draws a uniform half too
    keep = tu.dropout_keep(torch.Generator().manual_seed(0), H, W, "cpu")
    assert len(set(keep.tolist())) == H * W // 2


LM_CASES = {"weighted": dict(using_weight=True),
            "dropout": dict(dropout=1),
            "weighted_dropout": dict(using_weight=True, dropout=1),
            "weighted_g2sp": dict(using_weight=True, normalize=False,
                                  reinit=False, raw_damping=True,
                                  train_damping=True)}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_update_weight_and_keep_set(case):
    """``lm_update`` weighted by the target confidence and over the
    keep-set, on the S2GP (normalized) and G2SP (raw, trained damping)
    settings (measured <= 1.1e-7 of max)."""
    kw = LM_CASES[case]
    pose, sat, grd, conf, jac = _system(1)
    jcfg, tcfg = ju.LMConfig(**kw), tu.LMConfig(**kw)
    key = jax.random.PRNGKey(3) if kw.get("reinit", True) else None
    damping = np.full((1, 3), 0.2, np.float32)
    want = ju.lm_update(jnp.asarray(pose), jnp.asarray(sat * 30),
                        None, jnp.asarray(grd), jnp.asarray(conf),
                        jnp.asarray(jac), jnp.asarray(damping), jcfg, key)
    draws = (_lm_draws(key, H * W, B, "dropout" in kw) if key is not None
             else None)
    tp, ts, tg, tc, tj, td = _t(pose, sat * 30, grd, conf, jac, damping)
    got = tu.lm_update(tp, ts, tg, tj, td, tcfg, draws, grd_conf=tc)
    _close(got.numpy(), want, case)
    if draws is not None:
        assert draws.used == draws.numbers.shape[0]


def test_lm_update_reinit_from_fed_numbers():
    """A shift leaving the range takes JAX's uniform draw (fed)."""
    pose, sat, grd, conf, jac = _system(2)
    jac *= 1e-3            # tiny J: a huge step, out of range
    jcfg, tcfg = ju.LMConfig(dropout=1), tu.LMConfig(dropout=1)
    key = jax.random.PRNGKey(11)
    want = np.asarray(ju.lm_update(
        jnp.asarray(pose), jnp.asarray(sat), None, jnp.asarray(grd),
        jnp.asarray(conf), jnp.asarray(jac), jnp.zeros(()), jcfg, key))
    assert (np.abs(want[:, :2]) < 1).all()   # every shift was redrawn
    tp, ts, tg, tc, tj = _t(pose, sat, grd, conf, jac)
    got = tu.lm_update(tp, ts, tg, tj, torch.zeros(()), tcfg,
                       _lm_draws(key, H * W, B), grd_conf=tc)
    np.testing.assert_allclose(got.numpy()[:, :2], want[:, :2], rtol=0,
                               atol=1e-6)


def test_implicit_updates_with_keep_set():
    """The per-pixel (gather) and row-affine (banded) implicit updates
    with dropout: the keep-set as a mask of the moments and the norms
    (JAX ``_implicit_moments``), against JAX on the same keys."""
    rng = np.random.RandomState(4)
    out, dx, dy, grd = (rng.randn(B, H, W, C).astype(np.float32)
                        for _ in range(4))
    mask = (rng.rand(1, H, W) > 0.2).astype(np.float32)
    duv = rng.randn(B, H, W, 2, 3).astype(np.float32)
    P0, dP = (rng.randn(B, H, 2, 3).astype(np.float32) for _ in range(2))
    pose = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    jcfg, tcfg = ju.LMConfig(dropout=1), tu.LMConfig(dropout=1)
    key = jax.random.PRNGKey(5)
    j = [jnp.asarray(a) for a in (pose, out, dx, dy, grd, mask)]
    t = _t(pose, out, dx, dy, grd, mask)
    want = ju.lm_update_implicit_pixel_norm(*j, jnp.asarray(duv),
                                            jnp.zeros(()), jcfg, key)
    got = tu.lm_update_implicit_pixel_norm(*t, *_t(duv), torch.zeros(()),
                                           tcfg, _lm_draws(key, H * W, B))
    _close(got.numpy(), want, "pixel")
    want = ju.lm_update_implicit(*j[:5], j[5], jnp.asarray(P0),
                                 jnp.asarray(dP), jnp.zeros(()), jcfg, key)
    got = tu.lm_update_implicit(*t[:5], t[5][0], *_t(P0, dP),
                                torch.zeros(()), tcfg,
                                _lm_draws(key, H * W, B))
    _close(got.numpy(), want, "row-affine")
    # without dropout the mask is the ray mask alone
    want0 = ju.lm_update_implicit_pixel_norm(*j, jnp.asarray(duv),
                                             jnp.zeros(()), ju.LMConfig(),
                                             key)
    assert np.abs(np.asarray(want0) - np.asarray(
        ju.lm_update_implicit_pixel_norm(*j, jnp.asarray(duv), jnp.zeros(()),
                                         jcfg, key))).max() > 1e-4


@pytest.mark.parametrize("dims", [(0, 1, 2), (0, 1)], ids=["3dof", "2dof"])
def test_sgd_adam_l1_steps(dims):
    """``sgd_update``, three ``adam_update`` rounds (t = 0, 1, 2, the
    state carried) and ``sgd_update_l1`` on the active DoFs."""
    pose, sat, grd, _, jac = _system(6)
    jcfg, tcfg = ju.LMConfig(active_dims=dims), tu.LMConfig(active_dims=dims)
    js, jg, jj = (jnp.asarray(a) for a in (sat, grd, jac))
    ts, tg, tj = _t(sat, grd, jac)
    _close(tu.sgd_update(*_t(pose), ts, tg, tj, tcfg).numpy(),
           ju.sgd_update(jnp.asarray(pose), js, None, jg, None, jj, jcfg),
           "sgd")
    _close(tu.sgd_update_l1(*_t(pose), ts, tg, tj, tcfg).numpy(),
           ju.sgd_update_l1(jnp.asarray(pose), js, jg, jj, jcfg), "l1")
    n = len(dims)
    jp, jm, jv = jnp.asarray(pose), jnp.zeros((B, n)), jnp.zeros((B, n))
    tp, tm, tv = _t(pose)[0], torch.zeros(B, n), torch.zeros(B, n)
    for t in range(3):
        jp, jm, jv = ju.adam_update(jp, js * (t + 1), jg, jj, jm, jv, t,
                                    jcfg, 0.8, 0.99)
        tp, tm, tv = tu.adam_update(tp, ts * (t + 1), tg, tj, tm, tv, t,
                                    tcfg, 0.8, 0.99)
        for g, w, name in ((tp, jp, "pose"), (tm, jm, "m"), (tv, jv, "v")):
            _close(g.numpy(), w, f"adam t={t} {name}")


@pytest.mark.parametrize("weighted", [0, 1], ids=["unweighted", "weighted"])
def test_gn_update(weighted):
    """``gn_update``: the undamped solve with its 1e-8 floor, the weight,
    and the re-init from the key's two draws (sample 1 pushed out;
    measured 5.9e-7 of max on sample 0)."""
    pose, sat, grd, conf, jac = _system(8)
    key = jax.random.PRNGKey(9)
    jcfg = ju.LMConfig(using_weight=bool(weighted))
    tcfg = tu.LMConfig(using_weight=bool(weighted))
    jac[1] *= 1e-4          # sample 1 steps far: re-init
    want = np.asarray(ju.gn_update(
        jnp.asarray(pose), jnp.asarray(sat), jnp.asarray(grd),
        jnp.asarray(conf), jnp.asarray(jac), jcfg, key))
    assert (np.abs(want[1, :2]) < 1).all() and np.abs(want[0, :2]).max() < 2.5
    draws = tu.PresetDraws(torch.from_numpy(_reinit_numbers(key, B)))
    got = tu.gn_update(*_t(pose, sat, grd, conf, jac), tcfg, draws)
    _close(got.numpy()[0], want[0], "gn sample 0")
    np.testing.assert_allclose(got.numpy()[1, :2], want[1, :2], rtol=0,
                               atol=1e-6)


def _jax_nnrefine(seed):
    """A JAX NNrefine params tree with every width's conv (flax creates a
    width's conv where the head runs it)."""
    head = JNNrefine()
    params = {}
    for i, c in enumerate((256, 128, 64, 16)):
        x = jnp.zeros((1, 4, 5, c))
        p = head.init(jax.random.PRNGKey(seed + i), x, x)["params"]
        params.update(p)
    return head, params


def test_nnrefine_matches_jax():
    """The head at each width on the same params (``state_dict_from_jax``
    carries ``nn_refine`` to ``NNrefine.*``), within 1e-5 of max
    (measured <= 2.3e-7); a width the JAX params lack becomes a zero conv;
    ``init_params`` draws the convs and dense kernels at flax's scale."""
    head, params = _jax_nnrefine(0)
    port = NNrefine()
    port.load_state_dict({k.split(".", 1)[1]: v
                          for k, v in _nnrefine(params).items()})
    rng = np.random.RandomState(1)
    for c in (256, 128, 64, 16):
        a, b = (rng.randn(2, 6, 7, c).astype(np.float32) for _ in range(2))
        want = head.apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
        _close(port(*_t(a, b)).detach().numpy(), want, f"width {c}")
    partial = {k: v for k, v in params.items() if k != "linear3"}
    sd = _nnrefine(partial)
    assert not sd["NNrefine.linear3.1.weight"].any()
    m = torch.nn.Module()
    m.NNrefine = NNrefine()
    m.cfg = type("C", (), {"direction": "S2GP", "damping": 0.1})()
    init_params(m, torch.Generator().manual_seed(0))
    w = m.NNrefine.mapping[1].weight
    assert abs(float(w.detach().std()) - 64 ** -0.5) < 0.3 * 64 ** -0.5
    assert not m.NNrefine.mapping[1].bias.any()


def _loss_inputs(seed, L=2, I=3, h=4, w=6, c=5):
    rng = np.random.RandomState(seed)
    traj = [rng.uniform(-1, 1, (B, I, L)).astype(np.float32)
            for _ in range(3)]
    gt = [rng.uniform(-1, 1, B).astype(np.float32) for _ in range(3)]
    ref = [rng.randn(B, h, w, c).astype(np.float32) * 0.1 for _ in range(L)]
    pred = [rng.randn(B, I, h, w, c).astype(np.float32) for _ in range(L)]
    gtf = [rng.randn(B, h, w, c).astype(np.float32) for _ in range(L)]
    puv = [rng.rand(B, I, h, w, 2).astype(np.float32) for _ in range(L)]
    guv = [rng.rand(B, h, w, 2).astype(np.float32) for _ in range(L)]
    # one iteration of level 0 with the points on the gt's: uv_diff = 0
    puv[0][:, 1] = guv[0]
    return traj, gt, ref, pred, gtf, puv, guv


@pytest.mark.parametrize("method", [1, 2, 3])
def test_loss_methods_match_jax(method):
    """Loss methods 1-3 with every diagnostic (``L1``-``L4`` as JAX fills
    them), within 1e-5 of max (measured <= 5.1e-7); ``normalize_feature``
    too; method 3's gradient is NaN wherever the points sit on the gt's,
    in both (sqrt at 0)."""
    traj, gt, ref, pred, gtf, puv, guv = _loss_inputs(method)
    coes = (100.0, 90.0, 80.0)
    lcoes = dict(coe_L1=1.0, coe_L2=2.0, coe_L3=3.0, coe_L4=4.0)
    jargs = [jnp.asarray(a) for a in traj + gt]
    want = jl.loss_func(method, *jargs, *coes, [jnp.asarray(a) for a in ref],
                        [jnp.asarray(a) for a in pred],
                        [jnp.asarray(a) for a in gtf],
                        [jnp.asarray(a) for a in puv],
                        [jnp.asarray(a) for a in guv], **lcoes)
    tpred = [p.requires_grad_() for p in _t(*pred)]
    got = tl.loss_func(method, *_t(*traj, *gt), *coes, _t(*ref), tpred,
                       _t(*gtf), _t(*puv), _t(*guv), **lcoes)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            _close(g.detach().numpy(), w, f"method {method} {name}")
    _close(tl.normalize_feature(_t(pred[0])[0]).numpy(),
           jl.normalize_feature(jnp.asarray(pred[0])), "normalize_feature")
    if method == 1:    # method 2 reads no round's projection
        got.loss.backward()
        assert all(torch.isfinite(p.grad).all() for p in tpred)
    if method == 3:
        puvt = [p.requires_grad_() for p in _t(*puv)]
        loss = tl.loss_func(3, *_t(*traj, *gt), *coes, _t(*ref), _t(*pred),
                            _t(*gtf), puvt, _t(*guv), **lcoes).loss
        loss.backward()

        def jloss(puv_):
            return jl.loss_func(3, *jargs, *coes,
                                [jnp.asarray(a) for a in ref],
                                [jnp.asarray(a) for a in pred],
                                [jnp.asarray(a) for a in gtf], puv_,
                                [jnp.asarray(a) for a in guv], **lcoes).loss
        jg = jax.grad(jloss)([jnp.asarray(a) for a in puv])
        for g, w in zip(puvt, jg):
            np.testing.assert_array_equal(torch.isnan(g.grad).numpy(),
                                          np.isnan(np.asarray(w)))
        assert torch.isnan(puvt[0].grad).any()
