"""KITTI train/eval CLI (port of ``highlyaccurate_tpu/cli/train_kitti.py``),
flag-compatible with the reference script (train_kitti.py: flags :426-485,
save-path scheme :488-521, train loop :319-423, eval protocol :34-315).

    python -m highlyaccurate_tpu_torch.cli.train_kitti --test 0 \\
        --synthetic 16 --batch_size 8            # train, then test1/test2
    python -m highlyaccurate_tpu_torch.cli.train_kitti --test 1   # eval

The JAX CLI's flags, plus ``--device`` (default ``cuda``, which raises
without a GPU; ``cpu`` runs the kernels' plain versions).  One device: the
model holds its weights, the train step updates them in place, and an
epoch's evaluation runs on the same model.  Checkpoints are torch
``state_dict`` files in the reference layout (``<save_path>/model_<n>.pth``,
``Model_best.pth``); the result files are the reference's
(``Test{1,2}_results.txt`` and ``.mat``).  ``--remat`` and
``--use_banded_warp 2`` are accepted and change no output.
``--use_banded_warp 0`` runs the gather sampler; it is the faithful
default of ``--test 1 --import_pth``, which also resolves to the full G2SP
grid and float32 features, as the JAX CLI does.  ``--pose_hypotheses P``
evaluates with P starts per image (the model's multi-start sweep).  The
solver options run as the models take them: ``--Optimizer`` (LM, SGD,
ADAM with ``--beta1`` / ``--beta2``, NN), ``--using_weight``,
``--dropout``, ``--level_first`` and ``--loss_method`` 0-3 (G2SP: 0).
So do the projection options: ``--proj polar`` or ``nn`` (S2GP: the polar
rays; G2SP nn: the re-laid-out ground branch and the in-plane warp; both
on the gather sampler) and ``--use_gt_depth 1`` (the gather sampler on
the flat rays: the data carries no depth, as in JAX), with the JAX save
path suffixes ``_polar``, ``_nn`` and ``_depth``.

Quirks kept on purpose: Adam is re-created every epoch with a poly-decayed
lr; ``--test 1`` loads ``model_1`` as the reference loads ``model_1.pth``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from highlyaccurate_tpu_torch.config import Config, config_from_args
from highlyaccurate_tpu_torch.eval.metrics import EvalResults, denormalize


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # reference flags (train_kitti.py:426-485)
    p.add_argument("--resume", type=int, default=0)
    p.add_argument("--test", type=int, default=1)
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
    p.add_argument("--level_first", type=int, default=0)
    p.add_argument("--proj", type=str, default="geo")
    p.add_argument("--use_gt_depth", type=int, default=0)
    p.add_argument("--dropout", type=int, default=0)
    p.add_argument("--use_hessian", type=int, default=0)
    p.add_argument("--visualize", type=int, default=0)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    # framework flags (the JAX CLI's)
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic samples instead of disk data")
    p.add_argument("--import_pth", type=str, default=None,
                   help="path to a reference .pth checkpoint to evaluate")
    p.add_argument("--pretrained_vgg16", type=str, default=None,
                   help="local torchvision VGG16 ImageNet .pth: initialize "
                        "both encoder branches like the reference "
                        "(VGG.py:20)")
    p.add_argument("--save_root", type=str, default=".")
    p.add_argument("--compute_dtype", type=str, default=None,
                   help="feature compute dtype. Default: bfloat16 for "
                        "--test 1 on natively-trained checkpoints, float32 "
                        "for training and for --import_pth eval (strict "
                        "reference numerics)")
    p.add_argument("--keep_optimizer_state", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of train "
                        "steps 2-4 of the first epoch into this directory")
    p.add_argument("--async_ckpt", type=int, default=1,
                   help="epoch checkpoints write on a background thread, "
                        "overlapping the following eval (0 = synchronous)")
    p.add_argument("--remat", type=int, default=0,
                   help="accepted for the JAX CLI's command lines; no "
                        "effect here")
    p.add_argument("--use_banded_warp", type=int, default=None,
                   help="banded sampler (any nonzero value; 0 = the gather "
                        "sampler, the reference's numerics). Default 1, "
                        "except when evaluating --import_pth checkpoints "
                        "(0: reference weights were trained through the "
                        "gather-equivalent sampler)")
    p.add_argument("--pose_hypotheses", type=int, default=1,
                   help="multi-start LM hypotheses at eval (1 = the "
                        "reference's single start)")
    p.add_argument("--g2sp_restrict_grid", type=int, default=None,
                   help="G2SP: drop satellite columns that can never be in "
                        "view. Default 1, except when evaluating "
                        "--import_pth checkpoints (0)")
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--grd_h", type=int, default=256)
    p.add_argument("--grd_w", type=int, default=1024)
    p.add_argument("--sat_size", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def build_model(cfg: Config, device):
    """The model of ``cfg.direction`` on ``device``."""
    from highlyaccurate_tpu_torch.models.lm_g2sp import LMG2SP
    from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
    return {"S2GP": LMS2GP, "G2SP": LMG2SP}[cfg.direction](cfg,
                                                           device=device)


def make_loaders(cfg: Config, args, split: str):
    from highlyaccurate_tpu_torch.data.kitti import (KittiDataset, Loader,
                                                     SyntheticKitti)
    if args.synthetic:
        ds = SyntheticKitti(n=args.synthetic, grd_h=cfg.grd_h, grd_w=cfg.grd_w,
                            sat_size=cfg.sat_size,
                            seed={"train": 0, "test1": 1, "test2": 2}[split])
    else:
        ds = KittiDataset(cfg.dataset_root, split,
                          shift_range_lat=cfg.shift_range_lat,
                          shift_range_lon=cfg.shift_range_lon,
                          rotation_range=cfg.rotation_range,
                          grd_h=cfg.grd_h, grd_w=cfg.grd_w,
                          sat_size=cfg.sat_size)
    return Loader(ds, cfg.batch_size, shuffle=(split == "train"),
                  drop_last=(split == "train"))


def generator(device: torch.device, seed: int, n: int) -> torch.Generator:
    """The ``torch.Generator`` of the re-init draw for step or batch ``n``
    (JAX: ``fold_in(PRNGKey(seed), n)``), on ``device``."""
    mixed = np.random.SeedSequence((seed, n)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def init_model(model, seed: int):
    """Fresh weights drawn as the JAX model initialises them
    (``params.init_params``), from a generator seeded with ``seed``."""
    from highlyaccurate_tpu_torch.params import init_params
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def _visualize_batch(model, cfg: Config, batch, gen, traj_name: str,
                     feat_prefix: str, loop: int = 0):
    """``--visualize``: trajectory plot + per-level feature-PCA RGBs for the
    first sample of a batch (reference models_kitti.py:1285-1293,
    :1464-1469); shared by the train loop and evaluate()."""
    from highlyaccurate_tpu_torch.train.step import to_device
    from highlyaccurate_tpu_torch.utils import geo as _geo
    from highlyaccurate_tpu_torch.viz.visualize import (features_to_rgb,
                                                        pose_trajectory_plot)
    dev = model.device
    sat1 = to_device(batch["sat"][:1], dev)
    grd1 = to_device(batch["grd"][:1], dev)
    with torch.no_grad():
        lats, lons, ths = (t.cpu().numpy() for t in model(
            sat1, grd1, mode="trajectory", generator=gen))
    save_dir = f"./visualize_rot{cfg.rotation_range}"
    pose_trajectory_plot(
        batch["sat"][0], lats, lons, ths, batch["gt_pose"],
        _geo.get_meter_per_pixel(), cfg.shift_range_lat, cfg.shift_range_lon,
        cfg.rotation_range, os.path.join(save_dir, f"traj_{traj_name}.png"))
    pred = torch.from_numpy(np.stack([lons[:, -1, -1], lats[:, -1, -1],
                                      ths[:, -1, -1]], -1)).to(dev)
    gt1 = to_device(batch["gt_pose"][:1], dev)
    for lvl, maps in enumerate(model.project_at_pose(sat1, grd1, pred, gt1)):
        features_to_rgb([m.float().cpu().numpy() for m in maps], save_dir,
                        prefix=f"{feat_prefix}_L{lvl}", loop=loop)


def evaluate(model, cfg: Config, args, split: str, save_path: str,
             epoch: int, best_rank: float, eval_step=None):
    """Reference test1/test2 protocol (train_kitti.py:34-172) on the
    model's current weights.  One warm-up batch runs before the clock (the
    reference measures steady-state inference, train_kitti.py:74-75);
    ``time_per_image`` is taken after the device has finished.  Writes the
    results and, when test1's rank improves, ``Model_best``."""
    from highlyaccurate_tpu_torch.train import step as step_lib
    from highlyaccurate_tpu_torch.train.checkpoint import save_params

    dev = model.device
    loader = make_loaders(cfg, args, split)
    if eval_step is None:
        eval_step = step_lib.make_eval_step(model, cfg)
    keys = ["sat", "grd"] + (["camera_k"] if cfg.direction == "G2SP" else [])

    def prep(batch):
        # async H2D copies; through device_prefetch batch i+1's copy
        # overlaps batch i's inference
        return batch, tuple(step_lib.to_device(batch[k], dev) for k in keys)

    def run_batch(placed, i):
        batch, args_dev = placed
        return batch, eval_step(*args_dev, generator(dev, args.seed, i))

    # warm-up: first launches (and cuDNN's choices) outside the clock
    for batch0 in loader:
        batch, (lat, _, _) = run_batch(prep(batch0), 0)
        lat.cpu()  # fence
        if cfg.visualize and cfg.direction == "S2GP":
            _visualize_batch(model, cfg, batch, generator(dev, 0, 0),
                             traj_name=f"{split}_{epoch}",
                             feat_prefix=f"feat_{split}_e{epoch}")
        break

    preds_lat, preds_lon, preds_th, gts = [], [], [], []
    t0 = time.time()
    n_images = 0
    for i, placed in enumerate(step_lib.device_prefetch(loader, prep)):
        batch, (lat, lon, th) = run_batch(placed, i)
        preds_lat.append(lat.cpu().numpy())
        preds_lon.append(lon.cpu().numpy())
        preds_th.append(th.cpu().numpy())
        gts.append(batch["gt_pose"])
        n_images += batch["sat"].shape[0]
        if i % 20 == 0:
            print(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # reference semantics are per IMAGE (train_kitti.py:74-75)
    duration = (time.time() - t0) / max(n_images, 1)

    gt = np.concatenate(gts)
    pred_shifts, pred_headings = denormalize(
        np.concatenate(preds_lat), np.concatenate(preds_lon),
        np.concatenate(preds_th), cfg.shift_range_lat, cfg.shift_range_lon,
        cfg.rotation_range)
    gt_shifts, gt_headings = denormalize(gt[:, 1], gt[:, 0], gt[:, 2],
                                         cfg.shift_range_lat,
                                         cfg.shift_range_lon,
                                         cfg.rotation_range)
    res = EvalResults(pred_shifts=pred_shifts, pred_headings=pred_headings,
                      gt_shifts=gt_shifts, gt_headings=gt_headings,
                      time_per_image=duration)
    m = res.compute()
    res.write(save_path, split.capitalize(), epoch)

    rank = m["rank_result"]
    if split == "test1" and rank > best_rank:
        save_params(save_path, "Model_best", model,
                    async_save=bool(cfg.async_ckpt))
    return rank


def _print_metrics(epoch: int, loop: int, lvl: int, metrics: dict):
    """The reference's every-10-loops lines (train_kitti.py:372-383)."""
    m = {k: v.cpu().numpy() for k, v in metrics.items() if k != "loss"}
    print(f"Epoch: {epoch} Loop: {loop} Delta: Level-{lvl}"
          f" loss: {np.round(float(m['loss_decrease'][lvl]), 4)}"
          f" lat: {np.round(float(m['shift_lat_decrease'][lvl]), 2)}"
          f" lon: {np.round(float(m['shift_lon_decrease'][lvl]), 2)}"
          f" rot: {np.round(float(m['thetas_decrease'][lvl]), 2)}")
    print(f"Epoch: {epoch} Loop: {loop} Last: Level-{lvl}"
          f" loss: {np.round(float(m['loss_last'][lvl]), 4)}"
          f" lat: {np.round(float(m['shift_lat_last'][lvl]), 2)}"
          f" lon: {np.round(float(m['shift_lon_last'][lvl]), 2)}"
          f" rot: {np.round(float(m['theta_last'][lvl]), 2)}")


def train(model, cfg: Config, args, save_path: str):
    from highlyaccurate_tpu_torch.train import step as step_lib
    from highlyaccurate_tpu_torch.train.checkpoint import (
        apply_vgg16_init, epoch_ckpt_name, load_params, load_train_state,
        save_params, save_train_state, wait_for_async_saves)
    from highlyaccurate_tpu_torch.train.state import (create_train_state,
                                                      reset_for_epoch)
    from highlyaccurate_tpu_torch.utils.profiling import trace

    dev = model.device
    init_model(model, args.seed)
    if args.resume:
        load_params(save_path, epoch_ckpt_name(args.resume - 1), model)
        print(f"resume from {epoch_ckpt_name(args.resume - 1)}")
    elif args.pretrained_vgg16:
        # reference from-scratch init: both branches start from ImageNet
        # VGG16 (reference VGG.py:20-28)
        apply_vgg16_init(model, args.pretrained_vgg16)
        print(f"encoder init from {args.pretrained_vgg16}")

    state = create_train_state(cfg, model)
    if args.resume and cfg.keep_optimizer_state:
        # resume with optimizer moments (the reference loses them: it
        # rebuilds Adam every epoch anyway)
        try:
            state = load_train_state(save_path,
                                     epoch_ckpt_name(args.resume - 1), state,
                                     model)
            print("resumed optimizer state")
        except FileNotFoundError:
            print("no full-state checkpoint; resuming params only")
    train_step = step_lib.make_train_step(model, cfg)
    eval_step = step_lib.make_eval_step(model, cfg)
    keys = ["sat", "grd"] + (["camera_k"] if cfg.direction == "G2SP"
                             else []) + ["gt_pose"]

    def place(batch):
        # async H2D copies; device_prefetch keeps the next batch's copy in
        # flight under the current step
        return batch, [step_lib.to_device(batch[k], dev) for k in keys]

    best_rank = 0.0
    prof = None
    for epoch in range(args.resume, cfg.epochs):
        state = reset_for_epoch(state, cfg, epoch)
        loader = make_loaders(cfg, args, "train")
        print("batch_size:", cfg.batch_size, "num batches:", len(loader))
        for loop, (batch, b) in enumerate(
                step_lib.device_prefetch(loader, place)):
            gen = generator(dev, args.seed, epoch * 100000 + loop)
            # trace of steps 2-4 (steps 0 and 1 carry the first launches)
            if args.profile_dir and epoch == args.resume and loop == 2:
                prof = trace(args.profile_dir)
                prof.__enter__()
            state, metrics = train_step(state, *b, gen)
            if cfg.visualize and loop % 100 == 0 and cfg.direction == "S2GP":
                # trajectory plots AND per-level feature-PCA RGBs
                # (reference models_kitti.py:1285-1293)
                _visualize_batch(model, cfg, batch, gen,
                                 traj_name=f"{epoch}_{loop}",
                                 feat_prefix=f"feat_e{epoch}_l{loop}",
                                 loop=loop)
            if prof is not None and loop == 4:
                prof.__exit__(None, None, None)
                prof = None
                print(f"profiler trace written to {args.profile_dir}")
            if loop % 10 == 9:
                _print_metrics(epoch, loop, cfg.n_levels - 1, metrics)

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
        cur = evaluate(model, cfg, args, "test1", save_path, epoch,
                       best_rank, eval_step)
        best_rank = max(best_rank, cur)
        evaluate(model, cfg, args, "test2", save_path, epoch, best_rank,
                 eval_step)
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
    save_path = cfg.save_path(args.save_root)
    os.makedirs(save_path, exist_ok=True)
    print("save_path:", save_path)

    model = build_model(cfg, device)

    if args.test:
        from highlyaccurate_tpu_torch.params import load_pth
        from highlyaccurate_tpu_torch.train.checkpoint import load_params
        if args.import_pth:
            model.load_state_dict(load_pth(
                args.import_pth, depth=model.GrdFeatureNet.estimate_depth))
            if cfg.use_banded_warp:
                print("note: evaluating an imported reference checkpoint "
                      "with the banded sampler; the faithful path for "
                      "torch-trained weights is --use_banded_warp 0")
        else:
            # reference quirk: --test 1 loads model_1.pth (train_kitti.py:546)
            load_params(save_path, "model_1", model)
        evaluate(model, cfg, args, "test1", save_path, 0, 1e9)
        evaluate(model, cfg, args, "test2", save_path, 0, 1e9)
    else:
        train(model, cfg, args, save_path)


if __name__ == "__main__":
    main()
