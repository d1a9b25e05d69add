"""highlyaccurate_tpu_torch: the PyTorch/CUDA port of highlyaccurate_tpu.

Carries the KITTI LM_S2GP evaluation/serving path (geo projection, LM
solver, fused-moment banded kernel) and its training step (differentiable
banded sampler and its map gradient, loss method 0, Adam), the KITTI
LM_G2SP evaluation and training step (projective-line sampler and its map
gradient; the fused pixel-moment kernel with ``g2sp_pixel_moments=1``),
and Ford LM_S2GP_Ford serving and training on the banded kernels, on an
NVIDIA Hopper GPU.  Each module names its counterpart in
``highlyaccurate_tpu``; the JAX package stays the numerical reference and
is never imported from here.

    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    loc = Localizer(Config(), pth_path="model_1.pth")        # device="cuda"
    out = loc.predict(sat_imgs, grd_imgs)
    loc = Localizer(Config(direction="G2SP"), pth_path=..., camera_k=K)
    loc = Localizer(Config(), pth_path=..., ford_extrinsics=(R_FL, T_FL),
                    ford_side_m=512 * 0.22)                       # Ford

    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step
    state = create_train_state(cfg, model)  # LMS2GP, LMG2SP or LMS2GPFord
    step = make_train_step(model, cfg)      # Ford: ford_side_m=512 * 0.22
    state, metrics = step(state, sat, grd, gt_pose, generator)   # S2GP
    state, metrics = step(state, sat, grd, camera_k, gt_pose, None)  # G2SP
    state, metrics = step(state, sat, grd, R_FL, T_FL, gt_pose,
                          generator)                             # Ford
"""

__version__ = "0.1.0"

from highlyaccurate_tpu_torch.config import Config  # noqa: F401
