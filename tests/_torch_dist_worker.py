"""One process of the port's data-parallel checks on gloo
(tests/test_torch_distributed.py):

    python _torch_dist_worker.py MODE RANK WORLD PORT OUT_DIR

MODE ``step``: one S2GP training step of the tiny model on a global batch
of 4 through ``make_train_step(mesh=)``, this process on its rows; writes
``step_<rank>.npz`` (loss, the averaged gradients, the weights after
Adam), and rank 0 also ``single.npz``, the same step of one process on the
whole batch.  MODE ``cli``: the KITTI driver trained one epoch on the
synthetic data, each rank with its own ``--save_root`` under OUT_DIR, so
the test can tell which rank wrote what.
"""

import os
import sys

import numpy as np
import torch

mode, rank, world, port, out = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)

from highlyaccurate_tpu_torch import Config  # noqa: E402
from highlyaccurate_tpu_torch.train import distributed  # noqa: E402

TINY = dict(grd_h=32, grd_w=128, sat_size=64, N_iters=1, level=-1, lr=1e-3)
G = 4


def _step(mesh):
    """(loss, {name: grad}, {name: weight after Adam}) of one step."""
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    from highlyaccurate_tpu_torch.params import init_params
    from highlyaccurate_tpu_torch.train import step as step_lib
    from highlyaccurate_tpu_torch.train.state import create_train_state

    cfg = Config(**TINY)
    model = LMS2GP(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"sat": rng.rand(G, 64, 64, 3).astype(np.float32),
             "grd": rng.rand(G, 32, 128, 3).astype(np.float32),
             "gt": rng.uniform(-0.5, 0.5, (G, 3)).astype(np.float32)}
    if mesh is not None:
        batch = step_lib.shard_batch(mesh, batch)
    else:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = create_train_state(cfg, model)
    step = step_lib.make_train_step(model, cfg, mesh)
    _, metrics = step(state, batch["sat"], batch["grd"], batch["gt"],
                      torch.Generator().manual_seed(5))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()
             if p.grad is not None}
    weights = {k: p.detach().numpy() for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads, weights


def _save(name, loss, grads, weights):
    np.savez(os.path.join(out, name), loss=loss,
             **{"g:" + k: v for k, v in grads.items()},
             **{"w:" + k: v for k, v in weights.items()})


if mode == "step":
    from highlyaccurate_tpu_torch.train import step as step_lib
    distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    assert distributed.world_size() == world
    assert distributed.local_batch_slice(G) == G // world
    mesh = step_lib.make_mesh()
    assert mesh.size == world and mesh.index == rank
    _save(f"step_{rank}.npz", *_step(mesh))
    if rank == 0:
        _save("single.npz", *_step(None))
    distributed.barrier()
elif mode == "cli":
    from highlyaccurate_tpu_torch.cli import train_kitti
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    train_kitti.main([
        "--device", "cpu", "--test", "0", "--epochs", "1", "--synthetic",
        "4", "--batch_size", "2", "--grd_h", "32", "--grd_w", "128",
        "--sat_size", "64", "--N_iters", "1", "--level", "-1",
        "--save_root", os.path.join(out, f"rank{rank}")])
else:
    raise SystemExit(f"unknown mode {mode!r}")
