"""Geographic / camera constants (port of ``highlyaccurate_tpu/utils/geo.py``).

Only what the S2GP and Ford paths need: the camera height, the ray epsilon and
the web-mercator ground resolution of the satellite patch.  Host numpy.
"""

from __future__ import annotations

import numpy as np

SATMAP_ZOOM = 18
CAMERA_HEIGHT = 1.65  # meters
SATMAP_ORIGINAL_SIDELENGTH = 512
SATMAP_PROCESS_SIDELENGTH = 512
DEFAULT_LAT = 49.015
EPS = 1e-7


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
