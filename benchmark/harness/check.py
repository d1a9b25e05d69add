"""The numbers that decide ``correct``, each against the limit the cell's
``limits/<workload>.json`` sets.  A number the file names and the run did
not produce counts as failed."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def pose_gaps(prog, ref) -> dict:
    """Per-image widest gap over the three pose terms, in normalized units
    (shift / range, heading / range), of the program's poses against the
    reference's, [N, 3] each: its largest, its 90th and 75th percentiles
    (which a tenth or a quarter of wrong answers moves) and its median."""
    gap = np.abs(np.asarray(prog, np.float64)
                 - np.asarray(ref, np.float64)).max(-1)
    if not np.isfinite(gap).all():
        return dict.fromkeys(("pose_gap_max", "pose_gap_p90",
                              "pose_gap_p75", "pose_gap_median"), math.inf)
    return {"pose_gap_max": float(gap.max()),
            "pose_gap_p90": float(np.quantile(gap, 0.9)),
            "pose_gap_p75": float(np.quantile(gap, 0.75)),
            "pose_gap_median": float(np.median(gap))}


def feature_gap(prog, ref) -> float:
    """The widest relative gap ||program - reference|| / ||reference|| over
    the feature maps of both branches and every level, each a tensor of
    the sampled images.  (Every map is L2-normalized, so a gap of norms
    would read 0: the norm of the difference is what moves.)  A map the
    program did not make for the whole batch reads inf."""
    if len(prog) != len(ref) or any(p is None for p in prog):
        return math.inf
    gaps = [float((p.double() - r.double()).norm() / r.double().norm())
            for p, r in zip(prog, ref)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def leaf_gaps(prog: dict, ref: dict, counted) -> dict:
    """Per counted leaf, |norm(program) - norm(reference)| over the larger
    of the reference leaf's norm and the median counted leaf's norm."""
    med = float(np.median([ref[k] for k in counted]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in counted}


def judge(values: dict, limits: dict):
    """(correct, rows): every limited number at or under its limit, and one
    row per number: (name, value, limit or None)."""
    rows = [(k, float(v), limits.get(k)) for k, v in values.items()]
    rows += [(k, math.nan, lim) for k, lim in limits.items()
             if k not in values]
    ok = all(lim is None or (math.isfinite(v) and v <= lim)
             for _, v, lim in rows)
    return ok, rows


@contextlib.contextmanager
def precision(mode: str):
    """The reference's feature precision ``mode`` (``float32``,
    ``bfloat16``, ``fp8``, or ``tf32``: float32 convolutions and matrix
    products on TF32); yields the mode ``vgg.features`` takes."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if mode == "tf32":
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield "float32" if mode == "tf32" else mode
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
