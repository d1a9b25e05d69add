"""Ford-AV multisweep data pipeline (port of
``highlyaccurate_tpu/data/ford.py``, a copy: host numpy, no framework).

Re-implements the reference Ford loaders
(reference dataLoader/Ford_dataset.py:81-348):

  * per-log file lists with curated frame-index ranges;
  * quaternion body pose -> yaw; satellite tile chosen by lat/lon name;
  * GT alignment via gps2utm offsets -> PIL affine + rotate + random (train) /
    file-fixed (test) shift/rot -> 512 center crop at 0.22 m/px, or the
    fused native warp (``native/``) for the train split when it builds;
  * calibration YAMLs parsed with the CfgNode-style reader.

PIL and ``yaml`` are imported only where a file is read, so
``SyntheticFord`` needs neither.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from highlyaccurate_tpu_torch.geometry.ford import qvec2angle, qvec2rotmat
from highlyaccurate_tpu_torch.utils import geo
from highlyaccurate_tpu_torch.utils.cfgnode import CfgNode

SATMAP_DIR = "SatelliteMaps_18"
DATA_FILE = "grd_sat_quaternion_latlon.txt"
DATA_FILE_TEST = "grd_sat_quaternion_latlon_test.txt"
POSE_FILE_DIR = "Calibration-V2/V2/"
FL_EX = "cameraFrontLeft_body.yaml"
FL_IN = "cameraFrontLeftIntrinsics.yaml"

METERS_PER_PIXEL = 0.22
SIDELENGTH = 512
SATMAP_SIDELENGTH_METERS = SIDELENGTH * METERS_PER_PIXEL
LAT0 = 42.29424422604817  # 08-04-Log0-img0 (reference Ford_dataset.py:116)

TRAIN_LOGS = [
    "2017-10-26/V2/Log1", "2017-10-26/V2/Log2", "2017-08-04/V2/Log3",
    "2017-10-26/V2/Log4", "2017-08-04/V2/Log5", "2017-08-04/V2/Log6",
]
TRAIN_LOGS_IMG_INDS = [
    list(range(4500, 8500)),
    list(range(3150)) + list(range(6000, 9200)) + list(range(11000, 15000)),
    list(range(1500)),
    list(range(7466)),
    list(range(3200)) + list(range(5300, 9900)) + list(range(10500, 11130)),
    list(range(1000, 3500)) + list(range(4500, 5000)) + list(range(7000, 7857)),
]
TEST_LOGS = [
    "2017-08-04/V2/Log1", "2017-08-04/V2/Log2", "2017-08-04/V2/Log3",
    "2017-08-04/V2/Log4", "2017-10-26/V2/Log5", "2017-10-26/V2/Log6",
]
TEST_LOGS_IMG_INDS = [
    list(range(100, 200)) + list(range(5000, 5500)) + list(range(7000, 8500)),
    list(range(2500, 3000)) + list(range(8500, 10500)) + list(range(12500, 13727)),
    list(range(3500, 5000)),
    list(range(1500, 2500)) + list(range(4000, 4500)) + list(range(7000, 9011)),
    list(range(3500)),
    list(range(2000, 2500)) + list(range(3500, 4000)),
]


def load_calibration(root: str):
    """Front-left camera extrinsics/intrinsics from the calibration YAMLs
    (reference Ford_dataset.py:118-145). Returns (R_FL, T_FL, K_FL)."""
    ex = CfgNode.load_yaml(os.path.join(root, POSE_FILE_DIR, FL_EX))
    q = ex.transform.rotation
    t = ex.transform.translation
    T_FL = np.array([t.x, t.y, t.z], np.float32)
    R_FL = qvec2rotmat([q.w, q.x, q.y, q.z]).astype(np.float32)

    intr = CfgNode.load_yaml(os.path.join(root, POSE_FILE_DIR, FL_IN))
    K_FL = np.array(intr.K, dtype=np.float32).reshape(3, 3)
    K_FL[0] = K_FL[0] / 1656 * 1024
    K_FL[1] = K_FL[1] / 860 * 256
    return R_FL, T_FL, K_FL


def synthesize_ford_sat(sat_img, b_delta_u: float, b_delta_v: float,
                        yaw_deg: float, gt_shift_u: float, gt_shift_v: float,
                        theta: float, shift_range_lat: float,
                        shift_range_lon: float, rotation_range: float,
                        out_size: int = SIDELENGTH):
    """PIL GT synthesis chain (reference Ford_dataset.py:185-208)."""
    from PIL import Image

    aligned = sat_img.transform(sat_img.size, Image.AFFINE,
                                (1, 0, b_delta_u, 0, 1, b_delta_v),
                                resample=Image.BILINEAR)
    oriented = aligned.rotate(yaw_deg)
    shifted = oriented.transform(
        oriented.size, Image.AFFINE,
        (1, 0, gt_shift_u * shift_range_lat / METERS_PER_PIXEL,
         0, 1, gt_shift_v * shift_range_lon / METERS_PER_PIXEL),
        resample=Image.BILINEAR)
    rotated = shifted.rotate(theta * rotation_range)
    w, h = rotated.size
    left, top = (w - out_size) // 2, (h - out_size) // 2
    return rotated.crop((left, top, left + out_size, top + out_size))


@dataclass
class FordSample:
    sat: np.ndarray        # [512, 512, 3]
    grd: np.ndarray        # [256, 1024, 3]
    gt_shift_u: float
    gt_shift_v: float
    gt_heading: float
    R_FL: np.ndarray       # [3, 3]
    T_FL: np.ndarray       # [3]
    name: str


class FordDataset:
    """Train/test dataset over the reference's Ford on-disk layout."""

    def __init__(self, root: str, split: str = "train",
                 logs: Optional[Sequence[str]] = None,
                 logs_img_inds: Optional[Sequence[List[int]]] = None,
                 shift_range_lat: float = 20.0, shift_range_lon: float = 20.0,
                 rotation_range: float = 10.0, whole: bool = False,
                 grd_h: int = 256, grd_w: int = 1024,
                 rng: Optional[np.random.RandomState] = None,
                 use_native_warp: Optional[bool] = None):
        # absolute root: the reference joins os.path.join(root, log, FL_dir)
        # where FL_dir ALREADY contains root/log (Ford_dataset.py:100,109) —
        # that collapses correctly only when root is absolute, so make it so
        root = os.path.abspath(root)
        self.root = root
        self.is_train = split == "train"
        self.shift_range_lat = shift_range_lat
        self.shift_range_lon = shift_range_lon
        self.rotation_range = rotation_range
        self.grd_h, self.grd_w = grd_h, grd_w
        self.rng = rng or np.random.RandomState()
        # fused single-pass C++ warp: default ON for training (throughput),
        # OFF for eval (PIL-exact resampling parity) — same policy as KITTI
        if use_native_warp is None:
            use_native_warp = self.is_train
        if use_native_warp:
            from highlyaccurate_tpu_torch import native
            use_native_warp = native.available()
        self.use_native_warp = use_native_warp

        if logs is None:
            logs = TRAIN_LOGS if self.is_train else TEST_LOGS
            logs_img_inds = (TRAIN_LOGS_IMG_INDS if self.is_train
                             else TEST_LOGS_IMG_INDS)

        data_file = DATA_FILE if self.is_train else DATA_FILE_TEST
        entries = []
        for log, inds in zip(logs, logs_img_inds):
            fl_dir = os.path.join(root, log, log.replace("/", "-") + "-FL")
            with open(os.path.join(root, log, data_file)) as f:
                lines = f.readlines()
            if self.is_train and not whole:
                lines = [lines[i] for i in inds]
            for line in lines:
                parts = line.strip().split(" ")
                grd_name = parts[0]
                vals = [float(p) for p in parts[1:]]
                entry = {
                    "grd": os.path.join(root, log, fl_dir,
                                        grd_name.replace(".txt", ".png")),
                    "q": vals[0:4],
                    "g_latlon": (vals[4], vals[5]),
                    "s_latlon": (vals[6], vals[7]),
                    "sat": os.path.join(root, log, SATMAP_DIR,
                                        f"{parts[7]}_{parts[8]}.png"),
                }
                if not self.is_train:
                    entry["fixed"] = (vals[8], vals[9], vals[10])
                entries.append(entry)
        self.entries = entries
        self.R_FL, self.T_FL, self.K_FL = load_calibration(root)
        self.satmap_sidelength_meters = SATMAP_SIDELENGTH_METERS

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, idx: int) -> FordSample:
        from PIL import Image

        e = self.entries[idx]
        with Image.open(e["grd"]) as im:
            grd = im.convert("RGB").resize((self.grd_w, self.grd_h),
                                           Image.BILINEAR)
        grd = np.asarray(grd, np.float32) / 255.0

        g_x, g_y = geo.gps2utm(*e["g_latlon"], lat0=e["s_latlon"][0])
        s_x, s_y = geo.gps2utm(*e["s_latlon"], lat0=e["s_latlon"][0])
        b_delta_u = (g_x - s_x) / METERS_PER_PIXEL
        b_delta_v = -(g_y - s_y) / METERS_PER_PIXEL
        _, _, yaw = qvec2angle(*e["q"])

        if self.is_train:
            gt_shift_u = self.rng.uniform(-1, 1)
            gt_shift_v = self.rng.uniform(-1, 1)
            theta = self.rng.uniform(-1, 1)
        else:
            gt_shift_u, gt_shift_v, theta = e["fixed"]

        with Image.open(e["sat"]) as im:
            sat_img = im.convert("RGB")
            if self.use_native_warp:
                from highlyaccurate_tpu_torch import native
                m = native.ford_synthesize_matrix(
                    b_delta_u, b_delta_v, yaw, gt_shift_u, gt_shift_v,
                    theta, self.shift_range_lat, self.shift_range_lon,
                    self.rotation_range, sat_img.size[0], sat_img.size[1],
                    SIDELENGTH, METERS_PER_PIXEL)
                sat = native.affine_warp(np.asarray(sat_img, np.uint8), m,
                                         (SIDELENGTH, SIDELENGTH),
                                         normalize=True)
            else:
                sat_crop = synthesize_ford_sat(
                    sat_img, b_delta_u, b_delta_v, yaw,
                    gt_shift_u, gt_shift_v, theta, self.shift_range_lat,
                    self.shift_range_lon, self.rotation_range)
                sat = np.asarray(sat_crop, np.float32) / 255.0

        return FordSample(sat=sat, grd=grd, gt_shift_u=gt_shift_u,
                          gt_shift_v=gt_shift_v, gt_heading=theta,
                          R_FL=self.R_FL, T_FL=self.T_FL, name=e["grd"])


def collate_ford(samples: List[FordSample]):
    return {
        "sat": np.stack([s.sat for s in samples]),
        "grd": np.stack([s.grd for s in samples]),
        "gt_pose": np.stack([
            np.array([s.gt_shift_u, s.gt_shift_v, s.gt_heading], np.float32)
            for s in samples]),
        "R_FL": np.stack([s.R_FL for s in samples]),
        "T_FL": np.stack([s.T_FL for s in samples]),
        "names": [s.name for s in samples],
    }


class SyntheticFord:
    """Random-image stand-in with the Ford sample interface."""

    def __init__(self, n: int = 32, grd_h: int = 256, grd_w: int = 1024,
                 sat_size: int = SIDELENGTH, seed: int = 0):
        self.n, self.grd_h, self.grd_w, self.sat_size = n, grd_h, grd_w, sat_size
        self.seed = seed
        # the actual Ford-AV FL-camera rig (cameraFrontLeft_body.yaml values,
        # reference Ford_dataset.py:118-129): optical->vehicle rotation
        # ~[0.5,-0.5,0.5,-0.5].  A wrong axis permutation here (e.g.
        # [0.5,0.5,-0.5,0.5]) maps camera-forward to body-UP, collapsing the
        # ground footprint to one satellite row and freezing the solver.
        self.R_FL = qvec2rotmat([0.496157034, -0.486630591,
                                 0.507791308, -0.509084328]).astype(np.float32)
        self.T_FL = np.array([1.470563, 0.405664, 1.243369], np.float32)
        self.satmap_sidelength_meters = sat_size * METERS_PER_PIXEL

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> FordSample:
        rng = np.random.RandomState(self.seed * 99991 + idx)
        gt = rng.uniform(-1, 1, 3)
        return FordSample(
            sat=rng.rand(self.sat_size, self.sat_size, 3).astype(np.float32),
            grd=rng.rand(self.grd_h, self.grd_w, 3).astype(np.float32),
            gt_shift_u=float(gt[0]), gt_shift_v=float(gt[1]),
            gt_heading=float(gt[2]), R_FL=self.R_FL, T_FL=self.T_FL,
            name=f"synthetic/{idx:06d}.png")
