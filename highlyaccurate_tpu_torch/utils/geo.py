"""Geographic / camera constants and conversions (port of
``highlyaccurate_tpu/utils/geo.py``, a copy: host numpy, no framework).

Conventions (identical to the reference):
  * real world: X south, Y down, Z east; origin on the ground plane.
  * satellite pixels: u east, v south (from top-left of the patch).
  * web-mercator zoom-18 imagery, downloaded at scale 2 -> ~0.2 m/px at
    lat 49.015 (KITTI, Karlsruhe).
"""

from __future__ import annotations

import numpy as np

# Constants (reference: utils.py:5-17)
CAMERA_GPS_SHIFT = (1.08, 0.26)
CAMERA_GPS_SHIFT_LEFT = (1.08, 0.26)
CAMERA_GPS_SHIFT_RIGHT = (1.08, 0.8)
SATMAP_ZOOM = 18
CAMERA_HEIGHT = 1.65  # meters
CAMERA_DISTANCE = 0.54  # meters (stereo baseline)
SATMAP_ORIGINAL_SIDELENGTH = 512
SATMAP_PROCESS_SIDELENGTH = 512
DEFAULT_LAT = 49.015
EPS = 1e-7

# KITTI ground-image geometry (reference: dataLoader/KITTI_dataset.py:28-31)
GRD_IMG_H = 256
GRD_IMG_W = 1024
GRD_ORI_IMG_H = 375
GRD_ORI_IMG_W = 1242


def get_camera_height() -> float:
    return CAMERA_HEIGHT


def get_process_satmap_sidelength() -> int:
    return SATMAP_PROCESS_SIDELENGTH


def get_meter_per_pixel(lat: float = DEFAULT_LAT, zoom: int = SATMAP_ZOOM,
                        scale: float = SATMAP_PROCESS_SIDELENGTH / SATMAP_ORIGINAL_SIDELENGTH
                        ) -> float:
    """Web-mercator ground resolution (reference: utils.py:142-146)."""
    meter_per_pixel = 156543.03392 * np.cos(lat * np.pi / 180.0) / (2 ** zoom)
    meter_per_pixel /= 2  # imagery fetched at scale 2
    meter_per_pixel /= scale
    return meter_per_pixel


def meter2latlon(lat, lon, x, y):
    """East/south shift in meters -> new (lat, lon) (reference: utils.py:37-50)."""
    r = 6378137.0
    flatten = 1 / 298257
    e2 = flatten * (2 - flatten)
    m = r * np.pi / 180
    coslat = np.cos(lat * np.pi / 180)
    w2 = 1 / (1 - e2 * (1 - coslat * coslat))
    w = np.sqrt(w2)
    kx = m * w * coslat
    ky = m * w * w2 * (1 - e2)
    return lat - y / ky, lon + x / kx


def gps2meters(lat_s, lon_s, lat_d, lon_d):
    """Meters between two GPS fixes, x east / y south (reference: utils.py:52-66)."""
    r = 6378137.0
    flatten = 1 / 298257
    e2 = flatten * (2 - flatten)
    m = r * np.pi / 180
    lat = (lat_s + lat_d) / 2
    coslat = np.cos(lat * np.pi / 180)
    w2 = 1 / (1 - e2 * (1 - coslat * coslat))
    w = np.sqrt(w2)
    kx = m * w * coslat
    ky = m * w * w2 * (1 - e2)
    x = (lon_d - lon_s) * kx
    y = (lat_s - lat_d) * ky
    return [x, y]


def gps2utm(lat, lon, lat0: float = DEFAULT_LAT):
    """Mercator projection used by KITTI devkit (reference: utils.py:69-78)."""
    r = 6378137.0
    s = np.cos(lat0 * np.pi / 180)
    x = s * r * np.pi * lon / 180
    y = s * r * np.log(np.tan(np.pi * (90 + lat) / 360))
    return x, y


def gps2distance(lat_s, lon_s, lat_d, lon_d):
    x, y = gps2meters(lat_s, lon_s, lat_d, lon_d)
    return np.sqrt(np.square(x) + np.square(y))


def get_camera_max_meter_shift() -> float:
    return float(np.linalg.norm(CAMERA_GPS_SHIFT))


def get_camera_gps_shift(heading: float):
    """GPS->camera offset rotated by heading (reference utils.py:164-167;
    note its y-term sign differs from the left/right variants)."""
    h = heading % (2 * np.pi)
    shift_x = CAMERA_GPS_SHIFT[0] * np.cos(h) + CAMERA_GPS_SHIFT[1] * np.sin(h)
    shift_y = CAMERA_GPS_SHIFT[1] * np.cos(h) - CAMERA_GPS_SHIFT[0] * np.sin(h)
    return shift_x, shift_y


def get_camera_gps_shift_left(heading: float):
    """GPS->left-camera offset rotated by heading (reference: utils.py:170-173)."""
    h = heading % (2 * np.pi)
    shift_x = CAMERA_GPS_SHIFT_LEFT[0] * np.cos(h) + CAMERA_GPS_SHIFT_LEFT[1] * np.sin(h)
    shift_y = CAMERA_GPS_SHIFT_LEFT[0] * np.sin(h) - CAMERA_GPS_SHIFT_LEFT[1] * np.cos(h)
    return shift_x, shift_y


def get_camera_gps_shift_right(heading: float):
    h = heading % (2 * np.pi)
    shift_x = CAMERA_GPS_SHIFT_RIGHT[0] * np.cos(h) + CAMERA_GPS_SHIFT_RIGHT[1] * np.sin(h)
    shift_y = CAMERA_GPS_SHIFT_RIGHT[0] * np.sin(h) - CAMERA_GPS_SHIFT_RIGHT[1] * np.cos(h)
    return shift_x, shift_y
