"""highlyaccurate_tpu_torch: the PyTorch/CUDA port of highlyaccurate_tpu.

Carries the KITTI LM_S2GP evaluation/serving path (geo projection, LM
solver, fused-moment banded kernel) and its training step (differentiable
banded sampler and its map gradient, loss method 0, Adam) on an NVIDIA
Hopper GPU.  Each module names its counterpart in ``highlyaccurate_tpu``;
the JAX package stays the numerical reference and is never imported from
here.

    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    loc = Localizer(Config(), pth_path="model_1.pth")        # device="cuda"
    out = loc.predict(sat_imgs, grd_imgs)

    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step
    state = create_train_state(cfg, model)          # model: LMS2GP
    step = make_train_step(model, cfg)
    state, metrics = step(state, sat, grd, gt_pose, generator)
"""

__version__ = "0.1.0"

from highlyaccurate_tpu_torch.config import Config  # noqa: F401
