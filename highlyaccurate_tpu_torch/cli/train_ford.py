"""Ford-AV train/eval CLI (port of ``highlyaccurate_tpu/cli/train_ford.py``),
flag-compatible with the reference script (train_ford.py: flags :343-412,
save-path scheme :415-455, per-log training :190-340, eval :39-186).

    python -m highlyaccurate_tpu_torch.cli.train_ford --test 0 \\
        --synthetic 16 --batch_size 8            # train, then test each epoch
    python -m highlyaccurate_tpu_torch.cli.train_ford --test 1   # eval

The JAX CLI's flags, plus ``--device`` (default ``cuda``, which raises
without a GPU; ``cpu`` runs the kernels' plain versions).  One device: the
model holds its weights, the train step updates them in place, and an
epoch's evaluation runs on the same model.  Ford specifics kept: per-log
training (``--train_log_start`` / ``--train_log_end``) and the test log
``--test_log_ind``; ``np.random.seed(2022)`` before the test set (the fixed
perturbations live in the test files, so the seed is moot); the per-log
result files of ``write_ford`` and ``Model_best`` when its rank (recall of
dist < 5 m and angle < 1 deg) improves; the ``--transformer`` restore of
``Model_best`` from the base experiment into frozen feature backbones
(reference train_ford.py:499-511; the transformer block itself is dead code
upstream, only the restore and freeze are live).  ``--test 1 --import_pth``
evaluates a reference checkpoint on the gather sampler at float32, as the
JAX CLI resolves it; ``--test 1`` on the port's own ``Model_best`` uses bf16
features.  ``--pose_hypotheses P`` evaluates with P starts per image.
The solver options run as the model takes them: ``--Optimizer`` LM, GN,
SGD or NN (ADAM raises ``ValueError``, as in JAX), ``--using_weight``,
``--dropout``, ``--level_first`` and ``--loss_method`` 0-3.  So do
``--proj`` polar or nn (no sky crop, the gather sampler), ``--estimate_depth
1`` (the depth heads and the lifted rays; save path suffix ``_Depth1``)
and ``--use_gt_depth 1`` (which the Ford model never reads, as in JAX).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from highlyaccurate_tpu_torch.cli.train_kitti import generator, init_model
from highlyaccurate_tpu_torch.config import Config, config_from_args
from highlyaccurate_tpu_torch.eval.metrics import (EvalResults, denormalize,
                                                   write_ford)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # reference flags (train_ford.py:343-412)
    p.add_argument("--resume", type=int, default=0)
    p.add_argument("--test", type=int, default=0)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--stereo", type=int, default=0)
    p.add_argument("--sequence", type=int, default=1)
    p.add_argument("--rotation_range", type=float, default=10.0)
    p.add_argument("--shift_range_lat", type=float, default=20.0)
    p.add_argument("--shift_range_lon", type=float, default=20.0)
    p.add_argument("--coe_shift_lat", type=float, default=100.0)
    p.add_argument("--coe_shift_lon", type=float, default=100.0)
    p.add_argument("--coe_heading", type=float, default=100.0)
    p.add_argument("--coe_L1", type=float, default=100.0)
    p.add_argument("--coe_L2", type=float, default=100.0)
    p.add_argument("--coe_L3", type=float, default=100.0)
    p.add_argument("--coe_L4", type=float, default=100.0)
    p.add_argument("--metric_distance", type=float, default=5.0)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--loss_method", type=int, default=0)
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--N_iters", type=int, default=5)
    p.add_argument("--using_weight", type=int, default=0)
    p.add_argument("--damping", type=float, default=0.1)
    p.add_argument("--train_damping", type=int, default=0)
    p.add_argument("--negative_samples", type=int, default=32)
    p.add_argument("--use_conf_metric", type=int, default=0)
    p.add_argument("--direction", type=str, default="S2GP")
    p.add_argument("--Load", type=int, default=0)
    p.add_argument("--Optimizer", type=str, default="LM")
    p.add_argument("--train_log_start", type=int, default=0)
    p.add_argument("--train_log_end", type=int, default=1)
    p.add_argument("--test_log_ind", type=int, default=0)
    p.add_argument("--transformer", type=int, default=0)
    p.add_argument("--estimate_depth", type=int, default=0)
    p.add_argument("--level_first", type=int, default=0)
    p.add_argument("--proj", type=str, default="geo")
    p.add_argument("--use_gt_depth", type=int, default=0)
    p.add_argument("--dropout", type=int, default=0)
    p.add_argument("--use_hessian", type=int, default=0)
    p.add_argument("--visualize", type=int, default=0)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--train_whole", type=int, default=0)
    p.add_argument("--test_whole", type=int, default=0)
    # framework flags (the JAX CLI's)
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic samples instead of disk data")
    p.add_argument("--import_pth", type=str, default=None,
                   help="path to a reference .pth checkpoint to evaluate")
    p.add_argument("--use_banded_warp", type=int, default=None,
                   help="banded sampler (0 = the gather sampler, the "
                        "reference's numerics). Default 1, except when "
                        "evaluating --import_pth checkpoints (0: reference "
                        "weights were trained through the gather-equivalent "
                        "sampler)")
    p.add_argument("--save_root", type=str, default=".")
    p.add_argument("--compute_dtype", type=str, default=None,
                   help="feature compute dtype. Default: bfloat16 for "
                        "--test 1 on natively-trained checkpoints, float32 "
                        "for training and for --import_pth eval (strict "
                        "reference numerics)")
    p.add_argument("--pretrained_vgg16", type=str, default=None,
                   help="local torchvision VGG16 ImageNet .pth: initialize "
                        "both encoder branches like the reference "
                        "(VGG.py:20)")
    p.add_argument("--keep_optimizer_state", type=int, default=0)
    p.add_argument("--pose_hypotheses", type=int, default=1,
                   help="multi-start LM hypotheses at eval (1 = the "
                        "reference's single start)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of train "
                        "steps 2-4 of the first epoch into this directory")
    p.add_argument("--async_ckpt", type=int, default=1,
                   help="epoch checkpoints write on a background thread, "
                        "overlapping the following eval (0 = synchronous)")
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--grd_h", type=int, default=256)
    p.add_argument("--grd_w", type=int, default=1024)
    p.add_argument("--sat_size", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def build_model(cfg: Config, device):
    """The Ford model on ``device`` (its ``check_supported`` refuses ADAM
    with ``ValueError``, as JAX does)."""
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    return LMS2GPFord(cfg, device=device)


def make_loader(cfg: Config, args, split: str):
    """(dataset, loader) of the train split or of test log
    ``--test_log_ind``: ``--synthetic N`` samples, or the Ford tree under
    ``--dataset_root``."""
    from highlyaccurate_tpu_torch.data.ford import (FordDataset,
                                                    SyntheticFord, TEST_LOGS,
                                                    TEST_LOGS_IMG_INDS,
                                                    TRAIN_LOGS,
                                                    TRAIN_LOGS_IMG_INDS,
                                                    collate_ford)
    from highlyaccurate_tpu_torch.data.kitti import Loader
    if args.synthetic:
        ds = SyntheticFord(n=args.synthetic, grd_h=cfg.grd_h, grd_w=cfg.grd_w,
                           sat_size=cfg.sat_size,
                           seed={"train": 0, "test": 1}[split])
    elif split == "train":
        s, e = args.train_log_start, args.train_log_end
        ds = FordDataset(cfg.dataset_root, "train", TRAIN_LOGS[s:e],
                         TRAIN_LOGS_IMG_INDS[s:e],
                         shift_range_lat=cfg.shift_range_lat,
                         shift_range_lon=cfg.shift_range_lon,
                         rotation_range=cfg.rotation_range,
                         whole=bool(args.train_whole),
                         grd_h=cfg.grd_h, grd_w=cfg.grd_w)
    else:
        i = args.test_log_ind
        ds = FordDataset(cfg.dataset_root, "test", TEST_LOGS[i:i + 1],
                         TEST_LOGS_IMG_INDS[i:i + 1],
                         shift_range_lat=cfg.shift_range_lat,
                         shift_range_lon=cfg.shift_range_lon,
                         rotation_range=cfg.rotation_range,
                         whole=bool(args.test_whole),
                         grd_h=cfg.grd_h, grd_w=cfg.grd_w)
    loader = Loader(ds, cfg.batch_size,
                    shuffle=(split == "train" and not cfg.visualize),
                    drop_last=(split == "train"), collate_fn=collate_ford)
    return ds, loader


def _host_rig(batch, n=None):
    """A batch's R_FL and T_FL as host tensors: the model reads its kernel
    layout from R_FL on the host and moves the rig to its device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(batch[k][:n]))
                 for k in ("R_FL", "T_FL"))


def _visualize_batch(model, cfg: Config, batch, side_m, gen, traj_name: str,
                     feat_prefix: str, loop: int = 0):
    """``--visualize``: trajectory plot + per-level feature-PCA RGBs for the
    first sample of a batch (reference visualize_utils.py:173-239
    RGB_iterative_pose_ford and the models_ford feature-PCA dumps); shared
    by the train loop and evaluate()."""
    from highlyaccurate_tpu_torch.train.step import to_device
    from highlyaccurate_tpu_torch.viz.visualize import (features_to_rgb,
                                                        pose_trajectory_plot)
    dev = model.device
    sat1 = to_device(batch["sat"][:1], dev)
    grd1 = to_device(batch["grd"][:1], dev)
    rig1 = _host_rig(batch, 1)
    with torch.no_grad():
        lats, lons, ths = (t.cpu().numpy() for t in model(
            sat1, grd1, side_m, *rig1, mode="trajectory", generator=gen))
    save_dir = f"./visualize_ford_rot{cfg.rotation_range}"
    # Ford pose is (shift_u = lat, shift_v = lon, heading)
    # (models_ford.py:823-824); the plotter expects (lon, lat, heading)
    gt = np.asarray(batch["gt_pose"])
    gt_plot = np.stack([gt[:, 1], gt[:, 0], gt[:, 2]], -1)
    pose_trajectory_plot(
        batch["sat"][0], lats, lons, ths, gt_plot, side_m / cfg.sat_size,
        cfg.shift_range_lat, cfg.shift_range_lon, cfg.rotation_range,
        os.path.join(save_dir, f"traj_{traj_name}.png"))
    pred = torch.from_numpy(np.stack([lats[:, -1, -1], lons[:, -1, -1],
                                      ths[:, -1, -1]], -1)).to(dev)
    per_level = model.project_at_pose(sat1, grd1, side_m, *rig1, pred,
                                      to_device(gt[:1], dev))
    for lvl, maps in enumerate(per_level):
        features_to_rgb([m.float().cpu().numpy() for m in maps], save_dir,
                        prefix=f"{feat_prefix}_L{lvl}", loop=loop)


def evaluate(model, cfg: Config, args, save_path: str, epoch: int,
             best_rank: float, eval_step=None, side_m=None):
    """The reference's test protocol on test log ``--test_log_ind``
    (train_ford.py:39-186) with the model's current weights.  One warm-up
    batch runs before the clock; ``time_per_image`` is taken after the
    device has finished.  Writes the per-log results (``write_ford``) and,
    when the rank improves on ``best_rank``, ``Model_best``.  Returns the
    rank."""
    from highlyaccurate_tpu_torch.train import step as step_lib
    from highlyaccurate_tpu_torch.train.checkpoint import save_params

    np.random.seed(2022)  # reference parity (train_ford.py:44-46)
    dev = model.device
    ds, loader = make_loader(cfg, args, "test")
    if side_m is None:
        side_m = ds.satmap_sidelength_meters
    if eval_step is None:
        eval_step = step_lib.make_eval_step(model, cfg, ford_side_m=side_m)

    def prep(batch):
        # async H2D copies; through device_prefetch batch i+1's copy
        # overlaps batch i's inference
        return batch, (step_lib.to_device(batch["sat"], dev),
                       step_lib.to_device(batch["grd"], dev),
                       *_host_rig(batch))

    def run_batch(placed, i):
        batch, args_dev = placed
        return batch, eval_step(*args_dev, generator(dev, 2022, i))

    # warm-up: first launches (and cuDNN's choices) outside the clock
    for batch0 in loader:
        batch, (lat, _, _) = run_batch(prep(batch0), 0)
        lat.cpu()  # fence
        if cfg.visualize:
            _visualize_batch(model, cfg, batch, side_m, generator(dev, 2022, 0),
                             traj_name=f"test_log{args.test_log_ind}_e{epoch}",
                             feat_prefix=f"feat_test_e{epoch}")
        break

    pu, pv, pt, gts = [], [], [], []
    t0 = time.time()
    n_images = 0
    for i, placed in enumerate(step_lib.device_prefetch(loader, prep)):
        batch, (u, v, th) = run_batch(placed, i)
        pu.append(u.cpu().numpy())
        pv.append(v.cpu().numpy())
        pt.append(th.cpu().numpy())
        gts.append(batch["gt_pose"])
        n_images += batch["sat"].shape[0]
        if i % 20 == 0:
            print(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    duration = (time.time() - t0) / max(n_images, 1)

    gt = np.concatenate(gts)
    pred_shifts, pred_headings = denormalize(
        np.concatenate(pu), np.concatenate(pv), np.concatenate(pt),
        cfg.shift_range_lat, cfg.shift_range_lon, cfg.rotation_range)
    gt_shifts, gt_headings = denormalize(gt[:, 0], gt[:, 1], gt[:, 2],
                                         cfg.shift_range_lat,
                                         cfg.shift_range_lon,
                                         cfg.rotation_range)
    res = EvalResults(pred_shifts, pred_headings, gt_shifts, gt_headings,
                      time_per_image=duration)
    rank = write_ford(res, save_path, args.test_log_ind, epoch)
    if rank > best_rank:
        save_params(save_path, "Model_best", model,
                    async_save=bool(cfg.async_ckpt))
    return rank


def train(model, cfg: Config, args, save_path: str, restore_path=None):
    from highlyaccurate_tpu_torch.train import step as step_lib
    from highlyaccurate_tpu_torch.train.checkpoint import (
        apply_vgg16_init, epoch_ckpt_name, load_params, load_train_state,
        save_params, save_train_state, wait_for_async_saves)
    from highlyaccurate_tpu_torch.train.state import (create_train_state,
                                                      reset_for_epoch)
    from highlyaccurate_tpu_torch.utils.profiling import trace

    dev = model.device
    ds, loader = make_loader(cfg, args, "train")
    side_m = ds.satmap_sidelength_meters
    init_model(model, args.seed)
    freeze = False
    if args.resume:
        load_params(save_path, epoch_ckpt_name(args.resume - 1), model)
        print(f"resume from {epoch_ckpt_name(args.resume - 1)}")
    elif args.pretrained_vgg16:
        # reference from-scratch init: both branches start from ImageNet
        # VGG16 (reference VGG.py:20-28)
        apply_vgg16_init(model, args.pretrained_vgg16)
        print(f"encoder init from {args.pretrained_vgg16}")
    elif restore_path is not None:
        # frozen-backbone partial restore (reference train_ford.py:499-511)
        load_params(restore_path, "Model_best", model)
        freeze = True
        print("Restore model from", restore_path,
              "done ... (backbones frozen)")

    state = create_train_state(cfg, model)
    if args.resume and cfg.keep_optimizer_state:
        try:
            state = load_train_state(save_path,
                                     epoch_ckpt_name(args.resume - 1), state,
                                     model)
            print("resumed optimizer state")
        except FileNotFoundError:
            print("no full-state checkpoint; resuming params only")
    train_step = step_lib.make_train_step(model, cfg, ford_side_m=side_m,
                                          freeze_backbones=freeze)
    eval_step = step_lib.make_eval_step(model, cfg, ford_side_m=side_m)

    def place(batch):
        # async H2D copies of the images and gt; the rig stays on the host
        return batch, (step_lib.to_device(batch["sat"], dev),
                       step_lib.to_device(batch["grd"], dev),
                       *_host_rig(batch),
                       step_lib.to_device(batch["gt_pose"], dev))

    best_rank = 0.0
    prof = None
    metrics = None
    for epoch in range(args.resume, cfg.epochs):
        state = reset_for_epoch(state, cfg, epoch)
        for loop, (batch, b) in enumerate(
                step_lib.device_prefetch(loader, place)):
            gen = generator(dev, args.seed, epoch * 100000 + loop)
            # trace of steps 2-4 (steps 0 and 1 carry the first launches)
            if args.profile_dir and epoch == args.resume and loop == 2:
                prof = trace(args.profile_dir)
                prof.__enter__()
            state, metrics = train_step(state, *b, gen)
            if cfg.visualize and loop % 100 == 0:
                _visualize_batch(model, cfg, batch, side_m, gen,
                                 traj_name=f"{epoch}_{loop}",
                                 feat_prefix=f"feat_e{epoch}_l{loop}",
                                 loop=loop)
            if prof is not None and loop == 4:
                prof.__exit__(None, None, None)
                prof = None
                print(f"profiler trace written to {args.profile_dir}")
            if loop % 10 == 9:
                lvl = cfg.n_levels - 1
                print(f"Epoch: {epoch} Loop: {loop}"
                      f" loss: {float(metrics['loss']):.4f}"
                      f" lat: {float(metrics['shift_lat_last'][lvl]):.2f}"
                      f" lon: {float(metrics['shift_lon_last'][lvl]):.2f}"
                      f" rot: {float(metrics['theta_last'][lvl]):.2f}")
        if prof is not None:  # first epoch ended before step 4
            prof.__exit__(None, None, None)
            prof = None
            print(f"profiler trace written to {args.profile_dir} "
                  "(short epoch: fewer than 5 batches)")
        print("taking snapshot ...")
        save_params(save_path, epoch_ckpt_name(epoch), model,
                    async_save=bool(cfg.async_ckpt))
        if cfg.keep_optimizer_state:
            save_train_state(save_path, epoch_ckpt_name(epoch), state, model,
                             async_save=bool(cfg.async_ckpt))
        best_rank = max(best_rank, evaluate(model, cfg, args, save_path,
                                            epoch, best_rank, eval_step,
                                            side_m))
    wait_for_async_saves()
    print("Finished Training")


def main(argv=None):
    from highlyaccurate_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    np.random.seed(args.seed)
    if args.use_banded_warp is None and args.test and args.import_pth:
        # the resolution itself lives in config_from_args; just surface it
        print("note: --import_pth defaults to the reference-faithful "
              "gather sampler (--use_banded_warp 0); pass "
              "--use_banded_warp 1 to opt into the banded kernel")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    restore_path, save_path = cfg.ford_paths(args.save_root)
    os.makedirs(save_path, exist_ok=True)
    print("save_path:", save_path)

    model = build_model(cfg, device)

    if args.test:
        from highlyaccurate_tpu_torch.params import load_pth
        from highlyaccurate_tpu_torch.train.checkpoint import load_params
        if args.import_pth:
            model.load_state_dict(load_pth(
                args.import_pth, depth=model.GrdFeatureNet.estimate_depth))
        else:
            load_params(save_path, "Model_best", model)
        evaluate(model, cfg, args, save_path, 0, 1e9)
    else:
        train(model, cfg, args, save_path, restore_path=restore_path)


if __name__ == "__main__":
    main()
