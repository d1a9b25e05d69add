"""Evaluation metric suite and results writers (port of
``highlyaccurate_tpu/eval/metrics.py``, a copy: host numpy).

The reference's eval protocol (train_kitti.py:34-172 / 175-315), byte for
byte: recall of euclidean distance, |lateral|, |longitudinal| at {1,3,5} m,
heading at {1,3,5} deg, joint lateral&angle, init-vs-pred means,
time-per-image, and the ``Test{1,2}_results.txt`` / ``.mat`` output files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

THRESHOLDS_M = [1, 3, 5]
THRESHOLDS_DEG = [1, 3, 5]


@dataclass
class EvalResults:
    pred_shifts: np.ndarray    # [N, 2] meters (lat, lon)
    pred_headings: np.ndarray  # [N, 1] degrees
    gt_shifts: np.ndarray      # [N, 2] meters (lat, lon)
    gt_headings: np.ndarray    # [N, 1] degrees
    time_per_image: float = 0.0
    metrics: Dict[str, float] = field(default_factory=dict)

    def compute(self) -> Dict[str, float]:
        """Full recall/mean suite (reference train_kitti.py:85-158)."""
        pred_shifts, gt_shifts = self.pred_shifts, self.gt_shifts
        distance = np.sqrt(np.sum((pred_shifts - gt_shifts) ** 2, axis=1))
        angle_diff = np.remainder(np.abs(self.pred_headings - self.gt_headings), 360)
        angle_diff = np.where(angle_diff > 180, 360 - angle_diff, angle_diff)
        init_dis = np.sqrt(np.sum(gt_shifts ** 2, axis=1))
        init_angle = np.abs(self.gt_headings)
        diff_shifts = np.abs(pred_shifts - gt_shifts)
        N = distance.shape[0]

        m: Dict[str, float] = {
            "init_dis_mean": float(np.mean(init_dis)),
            "pred_dis_mean": float(np.mean(distance)),
            "init_angle_mean": float(np.mean(init_angle)),
            "pred_angle_mean": float(np.mean(angle_diff)),
            "time_per_image": self.time_per_image,
        }
        for t in THRESHOLDS_M:
            m[f"distance_recall_{t}m"] = float(np.sum(distance < t) / N * 100)
            m[f"distance_recall_{t}m_init"] = float(np.sum(init_dis < t) / N * 100)
            m[f"lateral_recall_{t}m"] = float(np.sum(diff_shifts[:, 0] < t) / N * 100)
            m[f"lateral_recall_{t}m_init"] = float(
                np.sum(np.abs(gt_shifts[:, 0]) < t) / N * 100)
            m[f"longitudinal_recall_{t}m"] = float(np.sum(diff_shifts[:, 1] < t) / N * 100)
            m[f"longitudinal_recall_{t}m_init"] = float(
                np.sum(np.abs(gt_shifts[:, 1]) < t) / N * 100)
        for a in THRESHOLDS_DEG:
            m[f"angle_recall_{a}deg"] = float(np.sum(angle_diff < a) / N * 100)
            m[f"angle_recall_{a}deg_init"] = float(np.sum(init_angle < a) / N * 100)
        for t, a in zip(THRESHOLDS_M, THRESHOLDS_DEG):
            m[f"lat{t}m_angle{a}deg"] = float(
                np.sum((angle_diff[:, 0] < a) & (diff_shifts[:, 0] < t)) / N * 100)
            m[f"lat{t}m_angle{a}deg_init"] = float(
                np.sum((init_angle[:, 0] < a) & (np.abs(gt_shifts[:, 0]) < t)) / N * 100)
        # Best-model criterion.  DELIBERATE FIX vs the reference: its
        # train_kitti.py:162 broadcasts [N] (dist) & [N, 1] (angle) into an
        # [N, N] pair count — result == count(d<1)*count(a<1)/N*100, which
        # scales with N and can exceed 100 (verified by executing the
        # reference block: tests/test_losses_metrics.py
        # test_recall_table_matches_reference_metric_block).  We use the
        # per-sample joint recall — the quantity the reference's own
        # printed joint table computes (train_kitti.py:148-152).  Both are
        # monotone in the same direction, so model selection is compatible.
        m["rank_result"] = float(
            np.sum((distance < THRESHOLDS_M[0])
                   & (angle_diff[:, 0] < THRESHOLDS_DEG[0])) / N * 100)
        self.metrics = m
        return m

    # --- reference-format writers -----------------------------------------

    def write(self, save_path: str, split_name: str, epoch: int) -> None:
        """Append the human-readable block and dump raw arrays to .mat
        (reference train_kitti.py:82-161)."""
        os.makedirs(save_path, exist_ok=True)
        if not self.metrics:
            self.compute()
        m = self.metrics

        try:
            import scipy.io as scio
            scio.savemat(os.path.join(save_path, f"{split_name}_results.mat"),
                         {"gt_shifts": self.gt_shifts,
                          "gt_headings": self.gt_headings,
                          "pred_shifts": self.pred_shifts,
                          "pred_headings": self.pred_headings})
        except ImportError:
            np.savez(os.path.join(save_path, f"{split_name}_results.npz"),
                     gt_shifts=self.gt_shifts, gt_headings=self.gt_headings,
                     pred_shifts=self.pred_shifts,
                     pred_headings=self.pred_headings)

        lines: List[str] = [
            "====================================",
            f"       EPOCH: {epoch}",
            f"Time per image (second): {self.time_per_image}",
        ]
        for t in THRESHOLDS_M:
            lines.append(
                f"distance within {t} meters (pred, init): "
                f"{m[f'distance_recall_{t}m']} {m[f'distance_recall_{t}m_init']}")
        lines.append("------------------------")
        for t in THRESHOLDS_M:
            lines.append(
                f"lateral      within {t} meters (pred, init): "
                f"{m[f'lateral_recall_{t}m']} {m[f'lateral_recall_{t}m_init']}")
            lines.append(
                f"longitudinal within {t} meters (pred, init): "
                f"{m[f'longitudinal_recall_{t}m']} {m[f'longitudinal_recall_{t}m_init']}")
        lines.append("------------------------")
        for a in THRESHOLDS_DEG:
            lines.append(
                f"angle within {a} degrees (pred, init): "
                f"{m[f'angle_recall_{a}deg']} {m[f'angle_recall_{a}deg_init']}")
        lines.append("------------------------")
        for t, a in zip(THRESHOLDS_M, THRESHOLDS_DEG):
            lines.append(
                f"lat within {t} & angle within {a} (pred, init): "
                f"{m[f'lat{t}m_angle{a}deg']} {m[f'lat{t}m_angle{a}deg_init']}")
        lines.append("====================================")

        with open(os.path.join(save_path, f"{split_name}_results.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
        print("\n".join(lines))


def write_ford(res: "EvalResults", save_path: str, test_log_ind: int,
               epoch: int) -> float:
    """Ford per-log results writer (reference train_ford.py:100-176).

    Writes ``<ind>_result.mat`` / ``<ind>_results.txt`` and returns the Ford
    best-model criterion: recall of (dist < 5 m) & (angle < 1 deg).
    """
    os.makedirs(save_path, exist_ok=True)
    if not res.metrics:
        res.compute()
    m = res.metrics

    try:
        import scipy.io as scio
        scio.savemat(os.path.join(save_path, f"{test_log_ind}_result.mat"),
                     {"gt_shifts": res.gt_shifts, "gt_headings": res.gt_headings,
                      "pred_shifts": res.pred_shifts,
                      "pred_headings": res.pred_headings})
    except ImportError:
        pass

    lines = ["====================================",
             f"       EPOCH: {epoch}",
             f"Time per image (second): {res.time_per_image}"]
    for t in THRESHOLDS_M:
        lines.append(f"within {t} meters pred: {m[f'distance_recall_{t}m']}")
        lines.append(f"within {t} meters init: {m[f'distance_recall_{t}m_init']}")
    lines.append("------------------------")
    for t in THRESHOLDS_M:
        lines.append(f"lateral within {t} meters pred: {m[f'lateral_recall_{t}m']}")
        lines.append(f"lateral within {t} meters init: {m[f'lateral_recall_{t}m_init']}")
        lines.append(f"longitudinal within {t} meters pred: {m[f'longitudinal_recall_{t}m']}")
        lines.append(f"longitudinal within {t} meters init: {m[f'longitudinal_recall_{t}m_init']}")
    lines.append("------------------------")
    for a in THRESHOLDS_DEG:
        lines.append(f"within {a} degrees pred: {m[f'angle_recall_{a}deg']}")
        lines.append(f"within {a} degrees init: {m[f'angle_recall_{a}deg_init']}")
    lines.append("====================================")
    with open(os.path.join(save_path, f"{test_log_ind}_results.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))

    distance = np.sqrt(np.sum((res.pred_shifts - res.gt_shifts) ** 2, axis=1))
    angle_diff = np.remainder(np.abs(res.pred_headings - res.gt_headings), 360)
    angle_diff = np.where(angle_diff > 180, 360 - angle_diff, angle_diff)
    return float(np.sum((distance < 5) & (angle_diff[:, 0] < 1))
                 / distance.shape[0] * 100)


def denormalize(shifts_lat, shifts_lon, headings, shift_range_lat: float,
                shift_range_lon: float, rotation_range: float):
    """Normalized model outputs -> meters / degrees
    (reference train_kitti.py:77-80).

    Returns pred_shifts [N, 2] (lat, lon) and pred_headings [N, 1].
    """
    shifts = np.stack([np.asarray(shifts_lat), np.asarray(shifts_lon)], axis=-1)
    shifts = shifts * np.array([shift_range_lat, shift_range_lon]).reshape(1, 2)
    headings = np.asarray(headings).reshape(-1, 1) * rotation_range
    return shifts, headings
