"""Visualization: PCA feature RGBs and LM pose-trajectory plots (port of
``highlyaccurate_tpu/viz/visualize.py``, a copy: host numpy).

Capability parity with the reference's visualize_utils.py:7-239: per-level
PCA projection of satellite/ground/projected feature maps to RGB images,
and satellite-image scatter/quiver plots of the solver's pose trajectory
against the ground truth.  PCA via SVD; inputs are channel-last arrays.
matplotlib and PIL are imported only inside the functions that draw.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _pca_rgb(flat: np.ndarray, components: Optional[np.ndarray] = None):
    """Project [N, C] features to 3 channels via PCA; returns ([N, 3], comps)."""
    x = flat - flat.mean(axis=0, keepdims=True)
    if components is None:
        # top-3 right singular vectors of the centered feature matrix
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        components = vt[:3]
    proj = x @ components.T  # [N, 3]
    lo, hi = np.percentile(proj, 1, axis=0), np.percentile(proj, 99, axis=0)
    rgb = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return rgb, components


def features_to_rgb(feature_maps: Sequence[np.ndarray], save_dir: str,
                    prefix: str = "feat", loop: int = 0) -> list:
    """Save PCA-RGB renderings of channel-last feature maps.

    All maps share one PCA basis (fit on their concatenation), mirroring the
    reference's joint normalization (visualize_utils.py:7-101).
    Returns the list of written paths.
    """
    os.makedirs(save_dir, exist_ok=True)
    flats = [np.asarray(f).reshape(-1, f.shape[-1]) for f in feature_maps]
    comps = None
    _, comps = _pca_rgb(np.concatenate(flats, axis=0))

    paths = []
    from PIL import Image
    for i, f in enumerate(feature_maps):
        f = np.asarray(f)
        rgb, _ = _pca_rgb(f.reshape(-1, f.shape[-1]), comps)
        img = (rgb.reshape(f.shape[:-1] + (3,)) * 255).astype(np.uint8)
        if img.ndim == 4:  # batched: save first sample
            img = img[0]
        path = os.path.join(save_dir, f"{prefix}_{loop:04d}_{i}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths


def pose_trajectory_plot(sat_img: np.ndarray, shift_lats: np.ndarray,
                         shift_lons: np.ndarray, thetas: np.ndarray,
                         gt_pose: np.ndarray, meter_per_pixel: float,
                         shift_range_lat: float, shift_range_lon: float,
                         rotation_range: float, save_path: str,
                         sample: int = 0) -> str:
    """Scatter/quiver plot of the LM trajectory on the satellite patch.

    Reference visualize_utils.py:104-170 (KITTI) / :173-239 (Ford):
    iterations colored along a colormap, ground truth in a distinct marker,
    heading drawn as arrows.

    Args:
      sat_img: [A, A, 3] float in [0,1] (channel-last).
      shift_lats/shift_lons/thetas: [B, N_iters, L] normalized trajectories.
      gt_pose: [B, 3] normalized (shift_u=lon, shift_v=lat, heading).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    A = sat_img.shape[0]
    lats = np.asarray(shift_lats)[sample].reshape(-1) * shift_range_lat
    lons = np.asarray(shift_lons)[sample].reshape(-1) * shift_range_lon
    ths = np.asarray(thetas)[sample].reshape(-1) * rotation_range

    # meters -> satellite pixels: u east (lon), v south (-lat)
    us = A / 2 + lons / meter_per_pixel
    vs = A / 2 - lats / meter_per_pixel

    gt = np.asarray(gt_pose)[sample]
    gt_u = A / 2 + gt[0] * shift_range_lon / meter_per_pixel
    gt_v = A / 2 - gt[1] * shift_range_lat / meter_per_pixel

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(sat_img))
    colors = plt.cm.viridis(np.linspace(0, 1, len(us)))
    ax.scatter(us, vs, c=colors, s=18, label="LM iterations")
    for u, v, t, c in zip(us, vs, ths, colors):
        ang = np.deg2rad(t)
        ax.arrow(u, v, 8 * np.cos(ang), -8 * np.sin(ang), color=c,
                 head_width=2, alpha=0.8)
    ax.scatter([gt_u], [gt_v], c="red", marker="*", s=160, label="GT")
    gt_ang = np.deg2rad(gt[2] * rotation_range)
    ax.arrow(gt_u, gt_v, 10 * np.cos(gt_ang), -10 * np.sin(gt_ang),
             color="red", head_width=2)
    ax.legend(loc="upper right")
    ax.set_xlim(0, A)
    ax.set_ylim(A, 0)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path
