"""The port's checkpoints (``highlyaccurate_tpu_torch.train.checkpoint``):
a saved ``.pth`` loads into the JAX package through its own ``import_pth``
and gives the same params bit for bit; the Adam moments survive
``save_train_state`` / ``load_train_state``; an async save snapshots the
weights when it is called and a load after it reads them;
``apply_vgg16_init`` on a synthetic torchvision VGG16 state_dict equals the
JAX package's; a missing checkpoint raises the JAX package's error."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from highlyaccurate_tpu.config import Config as JConfig
from highlyaccurate_tpu.models.vggunet import VGGUnet as JVGGUnet
from highlyaccurate_tpu.train import checkpoint as jckpt
from highlyaccurate_tpu_torch import Config
from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
from highlyaccurate_tpu_torch.params import state_dict_from_jax
from highlyaccurate_tpu_torch.train import checkpoint as ckpt
from highlyaccurate_tpu_torch.train.state import (create_train_state,
                                                  reset_for_epoch)

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=1, level=3)


def _jax_params(seed):
    rng = np.random.RandomState(seed)
    net = JVGGUnet(level=3)
    return {"SatFeatureNet": net.init(jax.random.PRNGKey(seed), jnp.asarray(
                rng.rand(1, 64, 64, 3).astype(np.float32)))["params"],
            "GrdFeatureNet": net.init(jax.random.PRNGKey(seed + 1),
                                      jnp.asarray(rng.rand(1, 32, 128, 3)
                                                  .astype(np.float32)))
            ["params"],
            "damping": rng.randn(1, 3).astype(np.float32)}


def _model(params=None):
    model = LMS2GP(Config(**TINY), device="cpu")
    if params is not None:
        model.load_state_dict(state_dict_from_jax(params))
    return model


def _assert_state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_saved_pth_imports_into_jax(tmp_path):
    """``save_params`` writes the reference key layout: the JAX package's
    ``import_pth`` reads it back into the params it came from."""
    params = _jax_params(0)
    path = ckpt.save_params(str(tmp_path), "model_1", _model(params))
    assert path == str(tmp_path / "model_1.pth")
    got = jckpt.import_pth(path, JConfig(**TINY))
    want_leaves = jax.tree_util.tree_leaves_with_path(params)
    got_tree = jax.tree_util.tree_structure(got)
    assert got_tree == jax.tree_util.tree_structure(params)
    for (kp, w), g in zip(want_leaves, jax.tree_util.tree_leaves(got)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), kp


def _train_a_little(model, state, seed):
    """Two Adam steps on seeded gradients (moments and step counts set)."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        state.optimizer.step()
    return state


@pytest.mark.parametrize("async_save", [False, True])
def test_train_state_roundtrip_keeps_adam_moments(tmp_path, async_save):
    cfg = Config(**TINY, keep_optimizer_state=1)
    model = _model(_jax_params(1))
    state = _train_a_little(model, create_train_state(cfg, model), 2)
    state = reset_for_epoch(state, cfg, 3)
    state.step = 7
    ckpt.save_train_state(str(tmp_path), "model_3", state, model,
                          async_save=async_save)
    want_opt = copy.deepcopy(state.optimizer.state_dict())
    want_params = {k: v.clone() for k, v in model.state_dict().items()}
    _train_a_little(model, state, 3)  # after the save: not in the file

    fresh = _model()
    fstate = create_train_state(cfg, fresh)
    fstate = ckpt.load_train_state(str(tmp_path), "model_3", fstate, fresh)
    assert (fstate.step, fstate.epoch) == (7, 3)
    _assert_state_dicts_equal(fresh.state_dict(), want_params)
    got_opt = fstate.optimizer.state_dict()
    assert got_opt["param_groups"] == want_opt["param_groups"]
    assert got_opt["state"].keys() == want_opt["state"].keys()
    for i, s in want_opt["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got_opt["state"][i][k], s[k]), (i, k)
    # the moments are live: one more step moves both optimizers alike
    _train_a_little(fresh, fstate, 3)
    _assert_state_dicts_equal(fresh.state_dict(), model.state_dict())
    with pytest.raises(FileNotFoundError, match="model_9_full"):
        ckpt.load_train_state(str(tmp_path), "model_9", fstate, fresh)


def test_async_save_then_load_reads_new_weights(tmp_path):
    """The host copy is taken when ``save_params`` returns: weights changed
    afterwards are not in the file; a second async save of the changed
    weights is what the next load reads."""
    model = _model(_jax_params(4))
    ckpt.save_params(str(tmp_path), "model_0", model, async_save=True)
    first = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    loaded = ckpt.load_params(str(tmp_path), "model_0", _model())
    _assert_state_dicts_equal(loaded.state_dict(), first)

    ckpt.save_params(str(tmp_path), "model_0", model, async_save=True)
    loaded = ckpt.load_params(str(tmp_path), "model_0", _model())
    _assert_state_dicts_equal(loaded.state_dict(), model.state_dict())
    ckpt.wait_for_async_saves()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_0.pth"]


def test_async_saves_from_many_threads(tmp_path):
    """Async saves issued from 8 threads at once (a short switch
    interval), 5 each: every file holds the weights its save snapshot."""
    import sys
    import threading

    def worker(t):
        for i in range(5):
            m = torch.nn.Linear(4, 3)
            with torch.no_grad():
                m.weight.fill_(t * 10 + i)
            ckpt.save_params(str(tmp_path), f"m{t}_{i}", m, async_save=True)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    ckpt.wait_for_async_saves()
    for t in range(8):
        for i in range(5):
            sd = torch.load(tmp_path / f"m{t}_{i}.pth")
            assert torch.all(sd["weight"] == t * 10 + i), (t, i)


def test_apply_vgg16_init_matches_jax(tmp_path):
    """A synthetic torchvision VGG16 state_dict (``features.{0,...,14}``,
    ImageNet shapes) into both branches' encoder convs: the port's result
    equals the JAX package's, loaded from the same file."""
    gen = torch.Generator().manual_seed(5)
    shapes = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128),
              10: (256, 128), 12: (256, 256), 14: (256, 256)}
    vgg = {}
    for i, (o, c) in shapes.items():
        vgg[f"features.{i}.weight"] = torch.randn(o, c, 3, 3, generator=gen)
        vgg[f"features.{i}.bias"] = torch.randn(o, generator=gen)
    vgg["classifier.0.weight"] = torch.randn(4, 4, generator=gen)
    path = tmp_path / "vgg16.pth"
    torch.save(vgg, path)
    params = _jax_params(6)
    want = state_dict_from_jax(jckpt.apply_vgg16_init(params, str(path)))
    got = ckpt.apply_vgg16_init(_model(params), str(path)).state_dict()
    _assert_state_dicts_equal(got, want)
    assert torch.equal(got["GrdFeatureNet.conv14.bias"],
                       vgg["features.14.bias"])
    # the decoder keeps its own init
    assert torch.equal(got["SatFeatureNet.conv_dec1.1.weight"],
                       state_dict_from_jax(params)
                       ["SatFeatureNet.conv_dec1.1.weight"])


def test_missing_checkpoint_and_names(tmp_path):
    with pytest.raises(FileNotFoundError, match="train first"):
        ckpt.load_params(str(tmp_path), "model_1", _model())
    assert [ckpt.epoch_ckpt_name(e) for e in (0, 7, 100, 123)] == \
        [jckpt.epoch_ckpt_name(e) for e in (0, 7, 100, 123)]
