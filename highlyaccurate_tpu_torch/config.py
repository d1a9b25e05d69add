"""Experiment configuration (port of ``highlyaccurate_tpu/config.py``).

A frozen, hashable dataclass mirroring the reference's argparse flags, copied
field for field from the JAX package so one ``Config`` describes both
implementations.  Knobs that only shape the TPU kernels' schedule
(``banded_u_chunk``, ``pad_input_channels``, ``remat``) are accepted and have
no effect here: the JAX package documents them as numerically identical at
every value.  Options the port does not carry yet are refused by the model
(``models/lm_s2gp.py:check_supported``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    # experiment control
    resume: int = 0
    test: int = 1
    debug: int = 0
    epochs: int = 5
    lr: float = 1e-4
    batch_size: int = 3

    # pose prior ranges
    rotation_range: float = 10.0
    shift_range_lat: float = 20.0
    shift_range_lon: float = 20.0

    # loss coefficients
    coe_shift_lat: float = 100.0
    coe_shift_lon: float = 100.0
    coe_heading: float = 100.0
    coe_L1: float = 100.0
    coe_L2: float = 100.0
    coe_L3: float = 100.0
    coe_L4: float = 100.0
    loss_method: int = 0

    # solver
    level: int = 3
    N_iters: int = 5
    using_weight: int = 0
    damping: float = 0.1
    train_damping: int = 0
    direction: str = "S2GP"  # or G2SP
    Optimizer: str = "LM"  # LM | SGD | ADAM | NN | GN(ford)
    level_first: int = 0
    proj: str = "geo"  # geo | polar | nn
    use_gt_depth: int = 0
    dropout: int = 0
    use_hessian: int = 0
    estimate_depth: int = 0  # Ford only
    beta1: float = 0.9
    beta2: float = 0.999

    # misc reference flags kept for save-path parity
    stereo: int = 0
    sequence: int = 1
    metric_distance: float = 5.0
    negative_samples: int = 32
    use_conf_metric: int = 0
    Load: int = 0
    visualize: int = 0

    # Ford driver flags
    train_log_start: int = 0
    train_log_end: int = 1
    test_log_ind: int = 0
    transformer: int = 0
    train_whole: int = 0
    test_whole: int = 0

    # framework knobs (do not affect save-path)
    dataset_root: Optional[str] = None
    grd_h: int = 256   # ground image H
    grd_w: int = 1024  # ground image W
    sat_size: int = 512  # satellite patch side
    pose_hypotheses: int = 1  # multi-start LM (reference is always 1)
    compute_dtype: str = "float32"  # "float32" | "bfloat16" feature compute
    remat: int = 0  # training memory knob of the JAX package
    g2sp_restrict_grid: int = 1  # G2SP column restriction (G2SP only)
    use_banded_warp: int = 1  # banded line sampler in the S2GP geo solver
    #   (the JAX package's 2 = "force off-TPU"; any nonzero value selects
    #   the banded kernel here)
    use_implicit_lm: int = 1  # contract H/g from per-row moments
    use_fused_moments: int = 1  # eval: the kernel emits the 9 LM moments
    #   ([B,V,3,16]) instead of [B,V,W,C] out/dx/dy arrays
    g2sp_pixel_moments: int = 0  # G2SP per-pixel moment kernel (G2SP only)
    banded_u_chunk: int = -1  # TPU schedule knob; outputs identical
    pad_input_channels: int = 0  # TPU layout knob; outputs identical
    banded_bf16_map: int = 1  # sample the satellite map in bfloat16 inside
    #   the banded kernel (fp32 weights and accumulation)
    keep_optimizer_state: int = 0
    async_ckpt: int = 1

    @property
    def n_levels(self) -> int:
        """Number of pyramid levels returned by the feature net for `level`."""
        if self.level in (-1, -2, -3):
            return 1
        return int(self.level)

    @property
    def active_pose_dims(self) -> tuple:
        """Which pose DoFs the solver updates (reference: models_kitti.py:954-957).

        Returns indices into (shift_u, shift_v, heading).
        """
        if self.rotation_range == 0:
            return (0, 1)
        if self.shift_range_lat == 0 and self.shift_range_lon == 0:
            return (2,)
        return (0, 1, 2)

    def save_path(self, root: str = ".") -> str:
        """Reference-identical experiment directory (train_kitti.py:488-521)."""
        p = (
            f"./ModelsKitti/LM_{self.direction}"
            f"/lat{self.shift_range_lat}m_lon{self.shift_range_lon}m_rot{self.rotation_range}"
            f"_Lev{self.level}_Nit{self.N_iters}"
            f"_Wei{self.using_weight}"
            f"_Dam{self.train_damping}"
            f"_Load{self.Load}_{self.Optimizer}"
            f"_loss{self.loss_method}"
            f"_{self.coe_shift_lat}_{self.coe_shift_lon}_{self.coe_heading}"
            f"_{self.coe_L1}_{self.coe_L2}_{self.coe_L3}_{self.coe_L4}"
        )
        if self.level_first:
            p += "_Level1st"
        if self.proj != "geo":
            p += "_" + self.proj
        if self.use_gt_depth:
            p += "_depth"
        if self.use_hessian:
            p += "_Hess"
        if self.dropout > 0:
            p += "_Dropout" + str(self.dropout)
        if self.damping != 0.1:
            p += "_Damping" + str(self.damping)
        return os.path.normpath(os.path.join(root, p))
