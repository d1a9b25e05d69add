"""highlyaccurate_tpu_torch: the PyTorch/CUDA port of highlyaccurate_tpu.

Carries the KITTI LM_S2GP evaluation/serving path (geo projection, LM
solver, fused-moment banded kernel) and its training step (differentiable
banded sampler and its map gradient, loss method 0, Adam), and the KITTI
LM_G2SP evaluation and training step (projective-line sampler and its map
gradient), on an NVIDIA Hopper GPU.  Each module names its counterpart in
``highlyaccurate_tpu``; the JAX package stays the numerical reference and
is never imported from here.

    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    loc = Localizer(Config(), pth_path="model_1.pth")        # device="cuda"
    out = loc.predict(sat_imgs, grd_imgs)
    loc = Localizer(Config(direction="G2SP"), pth_path=..., camera_k=K)

    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step
    state = create_train_state(cfg, model)    # model: LMS2GP or LMG2SP
    step = make_train_step(model, cfg)
    state, metrics = step(state, sat, grd, gt_pose, generator)   # S2GP
    state, metrics = step(state, sat, grd, camera_k, gt_pose, None)  # G2SP
"""

__version__ = "0.1.0"

from highlyaccurate_tpu_torch.config import Config  # noqa: F401
