"""Port parity for the Ford data pipeline and its YAML reader: the port's
copies (``highlyaccurate_tpu_torch.data.ford``, ``utils.cfgnode``) against
the JAX package's on the same inputs.

* ``SyntheticFord`` samples and ``collate_ford`` batches equal JAX's, bit
  for bit (the same seeded numpy draws, the Ford data's own rig);
* ``load_calibration`` reads the fixture YAMLs of tests/test_data.py (the
  Ford-AV calibration schema) into the same R_FL, T_FL and K_FL;
* ``FordDataset`` over a small fake tree (one log, one ground image, one
  satellite tile, the per-log data files): the train split through the
  fused native warp or the PIL chain from a seeded RandomState, the test
  split's fixed perturbations, equal to JAX's samples bit for bit;
* ``CfgNode`` behaves as JAX's (tests/test_cli_ckpt_viz.py:test_cfgnode).
"""

import os

import numpy as np
import pytest

from highlyaccurate_tpu import native as jnative
from highlyaccurate_tpu.data import ford as jf
from highlyaccurate_tpu.utils.cfgnode import CfgNode as JCfgNode
from highlyaccurate_tpu_torch import native
from highlyaccurate_tpu_torch.data import ford as tf
from highlyaccurate_tpu_torch.utils.cfgnode import CfgNode
from test_data import FORD_FL_BODY_YAML, FORD_FL_INTRINSICS_YAML

LOG = "2017-08-04/V2/Log1"
S_LAT, S_LON = "42.294319", "-83.223880"
FIELDS = ("sat", "grd", "gt_shift_u", "gt_shift_v", "gt_heading", "R_FL",
          "T_FL", "name")


def _assert_samples_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "names":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_ford_and_collate_match(seed):
    kw = dict(n=3, grd_h=32, grd_w=128, sat_size=64, seed=seed)
    t, j = tf.SyntheticFord(**kw), jf.SyntheticFord(**kw)
    assert len(t) == len(j) == 3
    assert t.satmap_sidelength_meters == j.satmap_sidelength_meters
    for i in range(3):
        _assert_samples_equal(t[i], j[i])
    _assert_batches_equal(tf.collate_ford([t[0], t[2]]),
                          jf.collate_ford([j[0], j[2]]))


def _calibration(root):
    cal_dir = root / tf.POSE_FILE_DIR
    os.makedirs(cal_dir, exist_ok=True)
    (cal_dir / tf.FL_EX).write_text(FORD_FL_BODY_YAML)
    (cal_dir / tf.FL_IN).write_text(FORD_FL_INTRINSICS_YAML)


def test_load_calibration_matches(tmp_path):
    _calibration(tmp_path)
    for got, want in zip(tf.load_calibration(str(tmp_path)),
                         jf.load_calibration(str(tmp_path))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def ford_tree(tmp_path_factory):
    """One log of the reference's layout: the calibration YAMLs, a
    <log>-FL ground image, a SatelliteMaps_18 tile named by its lat/lon and
    the train / test data files (the test line with fixed perturbations)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("ford")
    _calibration(root)
    rng = np.random.RandomState(0)
    fl_dir = root / LOG / (LOG.replace("/", "-") + "-FL")
    fl_dir.mkdir(parents=True)
    Image.fromarray(rng.randint(0, 255, (86, 166, 3), np.uint8)).save(
        fl_dir / "1501822908477787266.png")
    sat_dir = root / LOG / tf.SATMAP_DIR
    sat_dir.mkdir(parents=True)
    Image.fromarray(rng.randint(0, 255, (600, 600, 3), np.uint8)).save(
        sat_dir / f"{S_LAT}_{S_LON}.png")
    base = (f"1501822908477787266.txt 0.9997 0.001 0.002 0.024 "
            f"42.294335 -83.223862 {S_LAT} {S_LON}")
    (root / LOG / tf.DATA_FILE).write_text(base + "\n")
    (root / LOG / tf.DATA_FILE_TEST).write_text(base + " 0.25 -0.5 0.125\n")
    return root


DS = dict(shift_range_lat=2.0, shift_range_lon=2.0, rotation_range=10.0,
          grd_h=32, grd_w=128)


@pytest.mark.parametrize("native_warp", [True, False])
def test_ford_train_split_matches(ford_tree, native_warp):
    """Train split: random GT from a seeded RandomState, the satellite
    patch through the fused native warp (or the PIL chain)."""
    assert native.available() == jnative.available()
    t, j = (m.FordDataset(str(ford_tree), "train", logs=[LOG],
                          logs_img_inds=[[0]], whole=True,
                          rng=np.random.RandomState(1),
                          use_native_warp=native_warp, **DS)
            for m in (tf, jf))
    assert t.use_native_warp == j.use_native_warp
    assert len(t) == len(j) == 1
    for _ in range(2):
        _assert_samples_equal(t[0], j[0])


def test_ford_test_split_matches(ford_tree):
    """Test split: the fixed perturbations of the line, the PIL chain, a
    relative root, and a batch of the shared ``Loader``."""
    from highlyaccurate_tpu.data.kitti import Loader as JLoader
    from highlyaccurate_tpu_torch.data.kitti import Loader
    t, j = (m.FordDataset(str(ford_tree), "test", logs=[LOG],
                          logs_img_inds=[[0]], **DS) for m in (tf, jf))
    assert not t.use_native_warp
    _assert_samples_equal(t[0], j[0])
    assert (t[0].gt_shift_u, t[0].gt_shift_v, t[0].gt_heading) == (
        0.25, -0.5, 0.125)
    _assert_batches_equal(
        next(iter(Loader(t, 1, collate_fn=tf.collate_ford))),
        next(iter(JLoader(j, 1, collate_fn=jf.collate_ford))))
    cwd = os.getcwd()
    os.chdir(ford_tree.parent)
    try:
        rel = tf.FordDataset(os.path.relpath(str(ford_tree)), "test",
                             logs=[LOG], logs_img_inds=[[0]], **DS)
        _assert_samples_equal(rel[0], j[0])
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("cls", [CfgNode, JCfgNode], ids=["port", "jax"])
def test_cfgnode(cls, tmp_path):
    c = cls({"transform": {"rotation": {"x": 1.0, "y": 2.0}}, "K": [1, 2]})
    assert c.transform.rotation.x == 1.0
    assert c.K == [1, 2]
    c2 = cls({"transform": {"rotation": {"x": 9.0}}})
    c.merge_from_other_cfg(c2)
    assert c.transform.rotation.x == 9.0 and c.transform.rotation.y == 2.0
    c.merge_from_list(["transform.rotation.x", 5.0])
    assert c.transform.rotation.x == 5.0
    c.freeze()
    with pytest.raises(AttributeError):
        c.new_key = 1
    c.defrost()
    c.new_key = 1
    assert c.new_key == 1
    path = tmp_path / "c.yaml"
    path.write_text(FORD_FL_BODY_YAML)
    loaded = cls.load_yaml(str(path))
    assert loaded == JCfgNode.load_yaml(str(path))
    assert loaded.clone() == loaded and loaded.clone() is not loaded
