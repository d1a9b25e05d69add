"""highlyaccurate_tpu_torch: the PyTorch/CUDA port of highlyaccurate_tpu.

Carries the KITTI LM_S2GP evaluation/serving path (geo projection, LM
solver, fused-moment banded kernel) on an NVIDIA Hopper GPU.  Each module
names its counterpart in ``highlyaccurate_tpu``; the JAX package stays the
numerical reference and is never imported from here.

    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.inference import Localizer
    loc = Localizer(Config(), pth_path="model_1.pth")        # device="cuda"
    out = loc.predict(sat_imgs, grd_imgs)
"""

__version__ = "0.1.0"

from highlyaccurate_tpu_torch.config import Config  # noqa: F401
