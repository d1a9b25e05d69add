"""KITTI cross-view data pipeline (port of
``highlyaccurate_tpu/data/kitti.py``, a copy: host numpy, no framework).

Re-implements the reference loaders (dataLoader/KITTI_dataset.py:41-383)
as a host-side pipeline feeding channel-last batches:

  * ground-truth synthesis runs through the exact PIL BILINEAR
    rotate/affine/crop sequence for the test splits, and through the fused
    native warp (``native/``) for the train split when it builds;
  * train split draws random (shift, rot) per sample; test splits read the
    *fixed* perturbations stored in the split files
    (``name shift_x shift_y theta`` lines) so runs are comparable;
  * a thread-pool prefetcher replaces torch DataLoader workers; batches are
    NHWC float32 in [0, 1] (the reference's ToTensor, no normalization);
  * the dataset root is a constructor argument.

PIL is imported only where a file is read, so ``SyntheticKitti`` needs no
Pillow.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from highlyaccurate_tpu_torch.utils import geo

GRD_IMG_H, GRD_IMG_W = geo.GRD_IMG_H, geo.GRD_IMG_W
GRD_ORI_H, GRD_ORI_W = geo.GRD_ORI_IMG_H, geo.GRD_ORI_IMG_W

SATMAP_DIR = "satmap"
RAW_DIR = "raw_data"
LEFT_CAM_DIR = "image_02/data"
OXTS_DIR = "oxts/data"

TRAIN_FILE = "train_files.txt"
TEST1_FILE = "test1_files.txt"
TEST2_FILE = "test2_files.txt"


def parse_calib_k(calib_path: str, grd_h: int = GRD_IMG_H,
                  grd_w: int = GRD_IMG_W) -> np.ndarray:
    """Left color camera K from calib_cam_to_cam.txt, rescaled to the model
    input size (reference KITTI_dataset.py:84-100)."""
    with open(calib_path) as f:
        for line in f:
            if "P_rect_02" in line:
                vals = line.split(":")[1].strip().split(" ")
                fx = float(vals[0]) * grd_w / GRD_ORI_W
                cx = float(vals[2]) * grd_w / GRD_ORI_W
                fy = float(vals[5]) * grd_h / GRD_ORI_H
                cy = float(vals[6]) * grd_h / GRD_ORI_H
                return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                                dtype=np.float32)
    raise ValueError(f"P_rect_02 not found in {calib_path}")


def synthesize_sat(sat_img, heading_rad: float, gt_shift_x: float,
                   gt_shift_y: float, theta: float, shift_range_lat: float,
                   shift_range_lon: float, rotation_range: float,
                   out_size: int = geo.SATMAP_PROCESS_SIDELENGTH):
    """PIL-exact GT synthesis chain (reference KITTI_dataset.py:128-152).

    rotate(-heading) -> affine(camera-GPS offset) -> affine(gt shift) ->
    rotate(theta * rotation_range) -> center crop.

    Args:
      sat_img: PIL RGB image; gt_shift_x/y, theta in the loader's sign
        convention (shift_x right-positive, shift_y up-positive *before* the
        sign flip the reference applies on return).
    Returns the cropped PIL image.
    """
    from PIL import Image

    meter_per_pixel = geo.get_meter_per_pixel(scale=1)
    shift_px_lat = shift_range_lat / meter_per_pixel
    shift_px_lon = shift_range_lon / meter_per_pixel

    sat_rot = sat_img.rotate(-heading_rad / np.pi * 180)
    sat_align_cam = sat_rot.transform(
        sat_rot.size, Image.AFFINE,
        (1, 0, geo.CAMERA_GPS_SHIFT_LEFT[0] / meter_per_pixel,
         0, 1, geo.CAMERA_GPS_SHIFT_LEFT[1] / meter_per_pixel),
        resample=Image.BILINEAR)
    sat_rand_shift = sat_align_cam.transform(
        sat_align_cam.size, Image.AFFINE,
        (1, 0, gt_shift_x * shift_px_lon,
         0, 1, -gt_shift_y * shift_px_lat),
        resample=Image.BILINEAR)
    sat_rand_rot = sat_rand_shift.rotate(theta * rotation_range)

    w, h = sat_rand_rot.size
    left = (w - out_size) // 2
    top = (h - out_size) // 2
    return sat_rand_rot.crop((left, top, left + out_size, top + out_size))


def _to_float_nhwc(pil_img, size_hw: Optional[Tuple[int, int]] = None):
    from PIL import Image
    if size_hw is not None and pil_img.size != (size_hw[1], size_hw[0]):
        pil_img = pil_img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(pil_img, dtype=np.float32) / 255.0


@dataclass
class Sample:
    sat: np.ndarray          # [A, A, 3] float32 in [0,1]
    camera_k: np.ndarray     # [3, 3]
    grd: np.ndarray          # [H, W, 3]
    gt_shift_u: float        # normalized, = -gt_shift_x (loader convention)
    gt_shift_v: float        # normalized, = -gt_shift_y
    gt_heading: float        # normalized theta
    name: str


class KittiDataset:
    """Train/test dataset over the reference's on-disk layout."""

    def __init__(self, root: str, split: str, shift_range_lat: float = 20.0,
                 shift_range_lon: float = 20.0, rotation_range: float = 10.0,
                 grd_h: int = GRD_IMG_H, grd_w: int = GRD_IMG_W,
                 sat_size: int = geo.SATMAP_PROCESS_SIDELENGTH,
                 file_list: Optional[Sequence[str]] = None,
                 rng: Optional[np.random.RandomState] = None,
                 use_native_warp: Optional[bool] = None):
        self.root = root
        self.split = split
        self.is_train = split == "train"
        self.shift_range_lat = shift_range_lat
        self.shift_range_lon = shift_range_lon
        self.rotation_range = rotation_range
        self.grd_h, self.grd_w = grd_h, grd_w
        self.sat_size = sat_size
        self.rng = rng or np.random.RandomState()
        # fused single-pass C++ warp: default ON for training (throughput),
        # OFF for eval (PIL-exact resampling parity, SURVEY.md §7.3-2)
        if use_native_warp is None:
            use_native_warp = self.is_train
        if use_native_warp:
            from highlyaccurate_tpu_torch import native
            use_native_warp = native.available()
        self.use_native_warp = use_native_warp

        if file_list is not None:
            self.lines = list(file_list)
        else:
            split_file = {"train": TRAIN_FILE, "test1": TEST1_FILE,
                          "test2": TEST2_FILE}[split]
            path = os.path.join(os.path.dirname(__file__), "splits", split_file)
            if not os.path.exists(path):
                path = os.path.join(root, split_file)
            with open(path) as f:
                self.lines = [l.rstrip("\n") for l in f if l.strip()]

        self._k_cache: dict = {}

    def __len__(self):
        return len(self.lines)

    def _camera_k(self, day_dir: str) -> np.ndarray:
        if day_dir not in self._k_cache:
            calib = os.path.join(self.root, RAW_DIR, day_dir,
                                 "calib_cam_to_cam.txt")
            self._k_cache[day_dir] = parse_calib_k(calib, self.grd_h, self.grd_w)
        return self._k_cache[day_dir]

    def __getitem__(self, idx: int) -> Sample:
        from PIL import Image

        line = self.lines[idx]
        if self.is_train:
            file_name = line
            gt_shift_x = self.rng.uniform(-1, 1)
            gt_shift_y = self.rng.uniform(-1, 1)
            theta = self.rng.uniform(-1, 1)
        else:
            # fixed perturbations (reference KITTI_dataset.py:206,267-281)
            file_name, sx, sy, th = line.split(" ")
            gt_shift_x, gt_shift_y, theta = -float(sx), -float(sy), float(th)

        day_dir = file_name[:10]
        drive_dir = file_name[:38]
        image_no = file_name[38:]

        camera_k = self._camera_k(day_dir)

        with Image.open(os.path.join(self.root, SATMAP_DIR, file_name)) as im:
            sat_map = im.convert("RGB")

        oxts = os.path.join(self.root, RAW_DIR, drive_dir, OXTS_DIR,
                            image_no.lower().replace(".png", ".txt"))
        with open(oxts) as f:
            heading = float(f.readline().split(" ")[5])

        grd_path = os.path.join(self.root, RAW_DIR, drive_dir, LEFT_CAM_DIR,
                                image_no.lower())
        with Image.open(grd_path) as im:
            grd = _to_float_nhwc(im.convert("RGB"), (self.grd_h, self.grd_w))

        if self.use_native_warp:
            from highlyaccurate_tpu_torch import native
            m = native.fused_synthesize_matrix(
                heading, gt_shift_x, gt_shift_y, theta, self.shift_range_lat,
                self.shift_range_lon, self.rotation_range,
                sat_map.size[0], sat_map.size[1], self.sat_size,
                geo.get_meter_per_pixel(scale=1))
            sat = native.affine_warp(np.asarray(sat_map, np.uint8), m,
                                     (self.sat_size, self.sat_size),
                                     normalize=True)
        else:
            sat_crop = synthesize_sat(sat_map, heading, gt_shift_x,
                                      gt_shift_y, theta, self.shift_range_lat,
                                      self.shift_range_lon,
                                      self.rotation_range, self.sat_size)
            sat = _to_float_nhwc(sat_crop, (self.sat_size, self.sat_size))

        return Sample(sat=sat, camera_k=camera_k, grd=grd,
                      gt_shift_u=-gt_shift_x, gt_shift_v=-gt_shift_y,
                      gt_heading=theta, name=file_name)


def collate(samples: List[Sample]):
    """Stack samples into a NHWC batch dict."""
    return {
        "sat": np.stack([s.sat for s in samples]),
        "camera_k": np.stack([s.camera_k for s in samples]),
        "grd": np.stack([s.grd for s in samples]),
        "gt_pose": np.stack([
            np.array([s.gt_shift_u, s.gt_shift_v, s.gt_heading], np.float32)
            for s in samples]),
        "names": [s.name for s in samples],
    }


class Loader:
    """Thread-pool prefetching batch iterator (replaces torch DataLoader)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 prefetch: int = 2, seed: int = 0, collate_fn=None):
        self.ds = dataset
        self.bs = batch_size
        self.collate = collate_fn if collate_fn is not None else collate
        self.shuffle = shuffle
        self.workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        batches = [order[i:i + self.bs]
                   for i in range(0, len(order), self.bs)]
        if self.drop_last and batches and len(batches[-1]) < self.bs:
            batches.pop()

        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = []
            it = iter(batches)

            def submit_next():
                try:
                    idxs = next(it)
                except StopIteration:
                    return
                pending.append(pool.submit(
                    lambda ii: self.collate([self.ds[int(j)] for j in ii]),
                    idxs))

            for _ in range(self.prefetch):
                submit_next()
            while pending:
                fut = pending.pop(0)
                submit_next()
                yield fut.result()


# ---------------------------------------------------------------------------
# synthetic data (tests / benchmarks without the KITTI tree on disk)
# ---------------------------------------------------------------------------

class SyntheticKitti:
    """Random-image stand-in with the real sample interface."""

    def __init__(self, n: int = 64, grd_h: int = GRD_IMG_H,
                 grd_w: int = GRD_IMG_W, sat_size: int = 512, seed: int = 0,
                 fixed_gt: bool = False):
        self.n = n
        self.grd_h, self.grd_w, self.sat_size = grd_h, grd_w, sat_size
        self.seed = seed
        self.fixed_gt = fixed_gt

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> Sample:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        gt = rng.uniform(-1, 1, 3)
        if self.fixed_gt:
            gt = np.zeros(3)
        k = np.array([[582.9802 * self.grd_w / 1024, 0, 496.242 * self.grd_w / 1024],
                      [0, 482.7076 * self.grd_h / 256, 125.0034 * self.grd_h / 256],
                      [0, 0, 1]], np.float32)
        return Sample(
            sat=rng.rand(self.sat_size, self.sat_size, 3).astype(np.float32),
            camera_k=k,
            grd=rng.rand(self.grd_h, self.grd_w, 3).astype(np.float32),
            gt_shift_u=float(gt[0]), gt_shift_v=float(gt[1]),
            gt_heading=float(gt[2]), name=f"synthetic/{idx:010d}.png")
