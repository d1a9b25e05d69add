"""Port parity for the KITTI data pipeline, all bit-exact: the port's
copies (``highlyaccurate_tpu_torch.data.kitti``, ``native``, ``utils.geo``,
``data/splits``) against the JAX package's modules on the same inputs.

* ``SyntheticKitti`` samples and ``Loader`` batches (order, ``drop_last``,
  the shuffle seed per epoch) are equal;
* ``KittiDataset`` over a fake file tree in the reference's on-disk layout
  (the pattern of tests/test_data.py ``test_kitti_real_file_tree``) gives
  equal samples for the train split (the native warp, a seeded
  ``RandomState``) and the test splits (the PIL chain);
* ``native.affine_warp`` and the matrix helpers equal the JAX package's;
* the split files are byte-identical;
* ``parse_calib_k`` and the geo functions give equal numbers.
"""

import pathlib

import numpy as np
import pytest
from PIL import Image

from highlyaccurate_tpu import native as jnative
from highlyaccurate_tpu.data import kitti as jk
from highlyaccurate_tpu.utils import geo as jgeo
from highlyaccurate_tpu_torch import native
from highlyaccurate_tpu_torch.data import kitti as tk
from highlyaccurate_tpu_torch.utils import geo

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "2011_09_26/2011_09_26_drive_0002_sync/0000000048.png"
NAME2 = "2011_09_26/2011_09_26_drive_0002_sync/0000000049.png"


def _assert_samples_equal(a, b):
    for f in ("sat", "camera_k", "grd"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.gt_shift_u, a.gt_shift_v, a.gt_heading, a.name) == \
        (b.gt_shift_u, b.gt_shift_v, b.gt_heading, b.name)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "names":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed,idx", [(0, 0), (1, 3), (2, 7)])
def test_synthetic_kitti_matches(seed, idx):
    kw = dict(n=8, grd_h=32, grd_w=128, sat_size=64, seed=seed)
    _assert_samples_equal(tk.SyntheticKitti(**kw)[idx],
                          jk.SyntheticKitti(**kw)[idx])
    kw["fixed_gt"] = True
    _assert_samples_equal(tk.SyntheticKitti(**kw)[idx],
                          jk.SyntheticKitti(**kw)[idx])


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True),
                                               (True, False)])
def test_loader_batches_match(shuffle, drop_last):
    """Two epochs of batches of 3 over 8 samples: the same order (a
    shuffle reseeded per epoch), the same ragged or dropped tail."""
    kw = dict(n=8, grd_h=16, grd_w=64, sat_size=32, seed=1)
    tl = tk.Loader(tk.SyntheticKitti(**kw), 3, shuffle=shuffle,
                   drop_last=drop_last, seed=5)
    jl = jk.Loader(jk.SyntheticKitti(**kw), 3, shuffle=shuffle,
                   drop_last=drop_last, seed=5)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(jl)
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """Two frames of one drive in the reference's layout: satmap/,
    raw_data/<day>/calib_cam_to_cam.txt and raw_data/<drive>/{oxts/data,
    image_02/data}."""
    root = tmp_path_factory.mktemp("kitti")
    day, drive = NAME[:10], NAME[:38]
    rng = np.random.RandomState(0)
    (root / "satmap" / drive).mkdir(parents=True)
    raw = root / "raw_data"
    (raw / day).mkdir(parents=True)
    (raw / day / "calib_cam_to_cam.txt").write_text(
        "S_rect_02: 1.242000e+03 3.750000e+02\n"
        "P_rect_02: 7.215377e+02 0.0 6.095593e+02 4.485728e+01 "
        "0.0 7.215377e+02 1.728540e+02 2.163791e-01 "
        "0.0 0.0 1.0 2.745884e-03\n")
    oxts = raw / drive / "oxts" / "data"
    oxts.mkdir(parents=True)
    img02 = raw / drive / "image_02" / "data"
    img02.mkdir(parents=True)
    for name, yaw in ((NAME, 0.30), (NAME2, -1.2)):
        Image.fromarray(rng.randint(0, 255, (160, 160, 3), np.uint8)) \
            .save(root / "satmap" / name)
        frame = name[38:].replace(".png", "")
        (oxts / f"{frame}.txt").write_text(
            f"49.01 8.43 112.9 0.01 0.02 {yaw} 0 0 0\n")
        Image.fromarray(rng.randint(0, 255, (128, 512, 3), np.uint8)) \
            .save(img02 / f"{frame}.png")
    return root


# small ranges keep the crop inside the 160 px fixture map
DS = dict(shift_range_lat=2.0, shift_range_lon=2.0, rotation_range=10.0,
          grd_h=32, grd_w=128, sat_size=64)


@pytest.mark.parametrize("native_warp", [True, False])
def test_kitti_train_split_matches(kitti_tree, native_warp):
    """Train split: random GT from a seeded RandomState, the sat patch
    through the fused native warp (or the PIL chain)."""
    assert native.available() == jnative.available()
    t = tk.KittiDataset(str(kitti_tree), "train", file_list=[NAME, NAME2],
                        rng=np.random.RandomState(1),
                        use_native_warp=native_warp, **DS)
    j = jk.KittiDataset(str(kitti_tree), "train", file_list=[NAME, NAME2],
                        rng=np.random.RandomState(1),
                        use_native_warp=native_warp, **DS)
    assert t.use_native_warp == j.use_native_warp
    for i in (0, 1, 0):
        _assert_samples_equal(t[i], j[i])


@pytest.mark.parametrize("split", ["test1", "test2"])
def test_kitti_test_split_matches(kitti_tree, split):
    """Test splits: fixed perturbations parsed from the line, the PIL
    chain, and the Loader's collate."""
    lines = [f"{NAME} 0.25 -0.5 0.125", f"{NAME2} -0.75 0.5 -0.5"]
    t = tk.KittiDataset(str(kitti_tree), split, file_list=lines, **DS)
    j = jk.KittiDataset(str(kitti_tree), split, file_list=lines, **DS)
    assert not t.use_native_warp
    for i in range(2):
        _assert_samples_equal(t[i], j[i])
    _assert_batches_equal(next(iter(tk.Loader(t, 2))),
                          next(iter(jk.Loader(j, 2))))


def test_kitti_split_lists_load(kitti_tree):
    """Without ``file_list`` both packages read their copy of the split
    file: the same lines."""
    for split in ("train", "test1", "test2"):
        t = tk.KittiDataset(str(kitti_tree), split, **DS)
        j = jk.KittiDataset(str(kitti_tree), split, **DS)
        assert len(t) == len(j) > 1000 and t.lines == j.lines


@pytest.mark.parametrize("fname", ["train_files.txt", "test1_files.txt",
                                   "test2_files.txt", "README.md",
                                   "LICENSE.upstream"])
def test_split_files_identical(fname):
    got = (ROOT / "highlyaccurate_tpu_torch/data/splits" / fname).read_bytes()
    want = (ROOT / "highlyaccurate_tpu/data/splits" / fname).read_bytes()
    assert got == want


def _warp_cases():
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, (70, 90, 3), np.uint8)
    f32 = rng.rand(70, 90, 3).astype(np.float32)
    kitti = native.fused_synthesize_matrix(0.4, 0.3, -0.6, 0.2, 20.0, 20.0,
                                           10.0, 90, 70, 48,
                                           geo.get_meter_per_pixel(scale=1))
    ford = native.ford_synthesize_matrix(3.0, -2.0, 12.0, 0.1, -0.2, 0.5,
                                         20.0, 20.0, 10.0, 90, 70, 48, 0.22)
    rot = native.rotate_matrix(17.0, 90, 70)
    return [(u8, kitti, False), (u8, kitti, True), (f32, ford, False),
            (u8, rot, True), (f32, native.compose_affine(rot, kitti), False)]


@pytest.mark.parametrize("case", range(5))
def test_native_affine_warp_matches(case):
    assert native.available(), "g++ could not build highlyaccurate_tpu_torch.native"
    img, m, normalize = _warp_cases()[case]
    got = native.affine_warp(img, m, (48, 48), normalize=normalize)
    want = jnative.affine_warp(img, m, (48, 48), normalize=normalize)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_native_matrices_match():
    mpp = geo.get_meter_per_pixel(scale=1)
    args = (0.4, 0.3, -0.6, 0.2, 20.0, 20.0, 10.0, 512, 512, 512, mpp)
    assert native.fused_synthesize_matrix(*args) == \
        jnative.fused_synthesize_matrix(*args)
    args = (3.0, -2.0, 12.0, 0.1, -0.2, 0.5, 20.0, 20.0, 10.0, 512, 512,
            512, 0.22)
    assert native.ford_synthesize_matrix(*args) == \
        jnative.ford_synthesize_matrix(*args)
    assert native.rotate_matrix(-33.0, 64, 48) == \
        jnative.rotate_matrix(-33.0, 64, 48)
    assert native.crop_matrix(640, 480, 256) == \
        jnative.crop_matrix(640, 480, 256)


def test_parse_calib_k_matches(kitti_tree):
    calib = str(kitti_tree / "raw_data" / NAME[:10] / "calib_cam_to_cam.txt")
    for hw in ((256, 1024), (32, 128)):
        got, want = tk.parse_calib_k(calib, *hw), jk.parse_calib_k(calib, *hw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


GEO_CALLS = [
    ("get_meter_per_pixel", ()), ("get_meter_per_pixel", (48.9, 18, 2.0)),
    ("get_camera_height", ()), ("get_process_satmap_sidelength", ()),
    ("meter2latlon", (49.015, 8.43, 12.5, -7.25)),
    ("gps2meters", (49.015, 8.43, 49.0151, 8.4312)),
    ("gps2utm", (49.015, 8.43)),
    ("gps2distance", (49.015, 8.43, 49.0151, 8.4312)),
    ("get_camera_max_meter_shift", ()),
    ("get_camera_gps_shift", (2.1,)), ("get_camera_gps_shift_left", (-0.7,)),
    ("get_camera_gps_shift_right", (7.0,)),
]


@pytest.mark.parametrize("fn,args", GEO_CALLS,
                         ids=[f"{f}{i}" for i, (f, _) in enumerate(GEO_CALLS)])
def test_geo_matches(fn, args):
    got, want = getattr(geo, fn)(*args), getattr(jgeo, fn)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for c in ("CAMERA_GPS_SHIFT_LEFT", "CAMERA_HEIGHT", "GRD_IMG_H",
              "GRD_ORI_IMG_W", "SATMAP_PROCESS_SIDELENGTH", "EPS"):
        assert getattr(geo, c) == getattr(jgeo, c), c
