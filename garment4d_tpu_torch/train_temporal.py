#!/usr/bin/env python
"""Training / evaluation entry point of the port.

    python -m garment4d_tpu_torch.train_temporal --config cfgs/skirt.yaml \
        --GarmentPCA 1 --batch_size 20 --T 10 --lr 1e-3 --lr_sche ...

Counterpart of the repo's `train_temporal.py`, with its flags
(`utils/config.py`) and stage selection:

  --GarmentPCA 1     canonical stage
  --GarmentPCALBS 1  posed stage
  --MGN 1            with --GarmentPCALBS 1: the MGN variant (models/mgn.py)
  --only_seg 1       segmentation-only training (canonical stage)
  --fix_PCA 1        freeze the canonical stage (posed stage)
  --GarmentPCA_pretrain PATH  canonical weights for the posed stage (a port
                              checkpoint or the reference's canonical .ckpt)
  --pretrained_model PATH     weights only (a port checkpoint, a Flax npz or
                              a reference .ckpt)
  --only_eval 1      one evaluation pass; with --vis it first writes the
                     predictions of the first two eval batches under
                     <output_dir>/vis (data/export.py)
  --spatial_sample 1         posed stage: Morton-ordered neighbourhood
                             sampling (models/posed.py)
  --candidate_reuse_margin M posed stage: reuse the body query's candidates
                             while the vertices move less than M
  --bf16 1           the canonical stage's dense stacks (the canonical
                     model, the posed model's frozen stage 1) compute in
                     bf16; parameters, geometry and outputs stay fp32;
                     the MGN variant ignores it, as in the JAX package
  --remat 1          accepted and logged, a no-op: the port's PE blocks
                     already save only their inputs for the backward
  --debug_nans 1     stop at the first NaN with FloatingPointError naming
                     the module or tensor (utils/debug_nans.py)
  --launcher pytorch|slurm  data-parallel training over a process group
                     (torchrun's environment, or Slurm's with --tcp_port);
                     --batch_size is the global batch; BatchNorm statistics
                     are the global batch's, so --syncbn is implied

    torchrun --nproc_per_node 2 -m garment4d_tpu_torch.train_temporal \
        --launcher pytorch --config cfgs/skirt.yaml --GarmentPCA 1 \
        --batch_size 20 ...

With --synthetic_data 1 it trains on synthetic batches (`data/synthetic.py`);
otherwise on the CLOTH3D tree the config names, read by `--num_workers`
loader threads and completed on the device (`data/cloth3d.py`). A
checkpoint at `<output_dir>/ckpt/<ckpt_name>` is resumed from. `main` runs
on the card unless the caller passes `device="cpu"` (with --launcher, on
gloo). Under --launcher each rank reads and steps on its own rows of every
global batch (`parallel.local_batch_indices`), and rank 0 alone writes the
logs, the scalars and the checkpoint.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from garment4d_tpu_torch import _device, parallel
from garment4d_tpu_torch.data.cloth3d import (
    Cloth3dDataset,
    Cloth3dPaths,
    finalize_batch,
    host_to_device,
)
from garment4d_tpu_torch.data.export import export_frame
from garment4d_tpu_torch.data.pipeline import ParallelItemLoader
from garment4d_tpu_torch.data.synthetic import make_batch
from garment4d_tpu_torch.models import (
    CanonicalGarmentModel,
    GarmentAssets,
    MgnGarmentModel,
    PosedGarmentModel,
)
from garment4d_tpu_torch.smpl import load_smpl, synthetic_smpl
from garment4d_tpu_torch.train import checkpoint as ckpt_lib
from garment4d_tpu_torch.train.loop import eval_one_epoch, fit, make_logger
from garment4d_tpu_torch.train.step import (
    body_inputs_from_batch,
    make_canonical_steps,
    make_posed_steps,
    make_state_for,
)
from garment4d_tpu_torch.utils.config import parse_args
from garment4d_tpu_torch.utils.debug_nans import NanTripwire


def _body_models(args, device):
    body_models = {}
    for gender in ("male", "female"):
        for ext in ("npz", "pkl"):
            p = os.path.join(args.smpl_model_dir, f"SMPL_{gender.upper()}.{ext}")
            if os.path.exists(p):
                body_models[gender] = load_smpl(p, device)
                break
        else:
            raise FileNotFoundError(
                f"SMPL_{gender.upper()} not found in {args.smpl_model_dir}")
    return body_models


def cloth3d_batches(args, cfg, npoints, body_models, device, logger, loaders,
                    window_seed=None):
    """(train_batches(epoch), eval_batches(epoch)) over the CLOTH3D tree:
    train windows shuffled by epoch with the last partial batch dropped,
    eval windows in order with the tail padded by repeats and masked out
    of the means by `valid_mask` (reference eval sampler,
    `utils/train_utils.py:12-31`). The train windows are drawn from
    `window_seed`, or unseeded without one (the reference's dataset). In a
    process group each rank reads only its rows of every global batch, and
    of its mask, so the ranks must draw the same windows (one seed for
    all). The loaders it makes are appended to `loaders`, for the caller
    to close."""
    paths = Cloth3dPaths(
        root=cfg.DATASET.ROOT_FOLDER,
        cloth3d_folder=cfg.DATASET.CLOTH3D_FOLDER,
        garment_folder=cfg.DATASET.GARMENT_FOLDER,
        template_prefix=cfg.DATASET.GARMENT_TEMPLATE_T_POSE_PREFIX)
    body_verts = body_models["male"].num_verts
    rng = None if window_seed is None else np.random.RandomState(window_seed)
    datasets = [Cloth3dDataset(
        paths, file_list, cfg.GARMENT.NAME, T=args.T, npoints=npoints,
        pca_dim=cfg.GARMENT.PCADIM, is_train=is_train,
        exclude_list=cfg.DATASET.EXCLUDE_SEQ_LIST or None, body_verts=body_verts, rng=rng)
        for file_list, is_train in ((cfg.DATASET.TRAIN_F_LIST, True),
                                    (cfg.DATASET.EVAL_F_LIST, False))]
    logger.info(f"train windows: {len(datasets[0])}  eval windows: {len(datasets[1])}")

    def make_gen(ds, shuffle, drop_last):
        # --num_workers threads overlap the file reads with device work
        # (reference DataLoader(num_workers=8)); 0 = synchronous
        loader = ParallelItemLoader(ds.raw_item, num_workers=args.num_workers)
        loaders.append(loader)

        def gen(epoch):
            order = np.arange(len(ds))
            if shuffle:
                np.random.RandomState(epoch).shuffle(order)
            bs = args.batch_size
            stop = len(order) - bs + 1 if drop_last else len(order)
            metas = []
            for i in range(0, stop, bs):
                idxs = list(order[i:i + bs])
                n_real = len(idxs)
                while len(idxs) < bs:
                    idxs.append(idxs[-1])
                mask = (np.arange(bs) < n_real).astype(np.float32)
                metas.append((parallel.local_batch_indices(idxs),
                              mask if (not shuffle and n_real < bs) else None))
            for (_, mask), items in zip(metas, loader.map_batches([m[0] for m in metas])):
                batch = finalize_batch(ds.collate(items), body_models)
                if mask is not None:
                    batch["valid_mask"] = host_to_device(parallel.local_batch_indices(mask),
                                                         device)
                yield batch
        return gen

    return make_gen(datasets[0], True, drop_last=True), make_gen(datasets[1], False, drop_last=False)


def _make_state(args, cfg, assets, body_model, device, logger):
    """The model on `device` with its weights (--pretrained_model, then the
    canonical bootstrap, both before the optimizer is built over the
    parameters left trainable) and its train state (in a process group
    every rank reads the same files), and the checkpoint path
    `<output_dir>/ckpt/<ckpt_name>` (reference build(),
    `train_temporal.py:136-156`), which `_resume` reads."""
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.remat:
        logger.info("--remat 1: a no-op on the port (its PE blocks save only their "
                    "inputs for the backward)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the initial weights, as JAX's PRNGKey(0)
        if args.GarmentPCALBS and args.MGN:
            if args.bf16:
                logger.info("--bf16 1: the MGN variant takes no --bf16, as in the JAX package")
            model = MgnGarmentModel(assets, body_model.faces)
        elif args.GarmentPCALBS:
            model = PosedGarmentModel(assets, body_model.faces, lbs_k=cfg.NETWORK.LBSK,
                                      iterations=cfg.NETWORK.ITERATION,
                                      spatial_sample=bool(args.spatial_sample),
                                      candidate_reuse_margin=args.candidate_reuse_margin,
                                      compute_dtype=compute_dtype)
        else:
            model = CanonicalGarmentModel(assets, only_seg=bool(args.only_seg),
                                          compute_dtype=compute_dtype)
    model = model.to(device)
    if args.pretrained_model:
        report = ckpt_lib.load_pretrained(args.pretrained_model, model)
        logger.info(f"loaded {len(report['loaded'])} tensors from "
                    f"{args.pretrained_model}; skipped {len(report['skipped'])}")
    if args.GarmentPCA_pretrain:
        report = ckpt_lib.bootstrap_canonical(args.GarmentPCA_pretrain, model)
        logger.info(f"bootstrapped canonical encoder from {args.GarmentPCA_pretrain} "
                    f"({len(report['loaded'])} tensors)")
    state = make_state_for(model, lr=args.lr,
                           freeze_canonical=bool(args.fix_PCA and args.GarmentPCALBS))
    return state, os.path.join(args.output_dir, "ckpt", args.ckpt_name)


def _resume(args, state, ckpt_path, logger):
    """The auto-resume from `ckpt_path` where it exists (not under
    --only_eval): -> (state, the epoch to start at, the best metric so
    far). A checkpoint written after epoch e resumes at e + 1 with its
    best, its dropout generator and its plateau schedule; the JAX package
    starts again at epoch 0."""
    if not os.path.isfile(ckpt_path) or args.only_eval:
        return state, 0, float("inf")
    state, saved_epoch, other = ckpt_lib.restore_checkpoint(ckpt_path, state)
    best = float(other.get("best_v_l2", float("inf")))
    logger.info(f"auto-resumed from {ckpt_path} (epoch {saved_epoch}, best {best}); "
                f"continuing at epoch {saved_epoch + 1}")
    return state, saved_epoch + 1, best


def main(argv=None, device=_device.DEFAULT):
    """Parse `argv` and train or evaluate; returns the fit history, or the
    eval means with --only_eval. With --launcher it joins the process group
    first and ends it after."""
    args, cfg = parse_args(argv)
    if not (args.GarmentPCA or args.GarmentPCALBS):
        raise SystemExit("select a stage: --GarmentPCA 1 or --GarmentPCALBS 1")
    if args.GarmentPCA_pretrain and not args.GarmentPCALBS:
        raise SystemExit("--GarmentPCA_pretrain bootstraps the posed stage: "
                         "pass --GarmentPCALBS 1")
    device = _device.resolve(device)
    dist_info = parallel.initialize_distributed(args.launcher, args.tcp_port, args.local_rank,
                                                device=device)
    try:
        return _run(args, cfg, dist_info)
    finally:
        if args.launcher:
            parallel.shutdown()


def _run(args, cfg, dist_info):
    device = dist_info["device"]
    data_parallel = parallel.in_group()
    local_batch = parallel.per_process_batch(args.batch_size)
    main_process = parallel.is_main_process()
    if main_process:
        os.makedirs(args.output_dir, exist_ok=True)
        logger = make_logger(args.output_dir)
    else:
        logger = make_logger(None)
        logger.setLevel(logging.WARNING)
    for key, val in sorted(vars(args).items()):
        logger.info(f"{key:20} {val}")
    if data_parallel:
        logger.info(f"data parallel over {dist_info['process_count']} processes "
                    f"({dist_info['backend']}): global batch {args.batch_size}, "
                    f"{local_batch} a rank")
    if args.syncbn:
        logger.info("--syncbn 1: BatchNorm statistics are the global batch's under "
                    "--launcher whatever --syncbn says, as in the JAX package")

    # ---------------- assets / body model ----------------
    if args.synthetic_data:
        assets = GarmentAssets.synthetic(name=cfg.GARMENT.NAME, num_rings=12, ring_size=16)
        body_models = {g: synthetic_smpl(num_verts=400, seed=s, device=device)
                       for s, g in enumerate(("male", "female"))}
        npoints = min(args.npoints, 2048)
    else:
        assets = GarmentAssets.from_files(
            cfg.GARMENT.NAME, cfg.GARMENT.TEMPLATE, cfg.GARMENT.PCACOMPONENTSFILE,
            pca_dim=cfg.GARMENT.PCADIM)
        body_models = _body_models(args, device)
        npoints = cfg.NETWORK.NPOINTS
    body_model = body_models["male"]

    loaders, tripwire = [], None
    try:
        # ---------------- data ----------------
        if args.synthetic_data:
            def batches_fn(split_seed):
                def gen(epoch):
                    for i in range(2):
                        batch = make_batch(assets, body_model, batch_size=args.batch_size,
                                           T=args.T, npoints=npoints,
                                           seed=split_seed * 1000 + epoch * 10 + i,
                                           device=device)
                        yield parallel.shard_batch(batch) if data_parallel else batch
                return gen
            train_batches, eval_batches = batches_fn(0), batches_fn(1)
        else:
            train_batches, eval_batches = cloth3d_batches(
                args, cfg, npoints, body_models, device, logger, loaders,
                window_seed=parallel.shared_seed() if data_parallel else None)

        # ---------------- model, state, steps ----------------
        state, ckpt_path = _make_state(args, cfg, assets, body_model, device, logger)
        state, start_epoch, best = _resume(args, state, ckpt_path, logger)
        model = state.model
        if args.debug_nans:
            tripwire = NanTripwire(model)
            logger.info(f"--debug_nans 1: NaN tripwire on {tripwire.modules} modules")
        if args.GarmentPCALBS:
            train_step, eval_step = make_posed_steps(model, assets, body_model.faces, cfg.LOSS,
                                                     tripwire=tripwire)
            eval_metric = "lbs_garment_msre"
        else:
            train_step, eval_step = make_canonical_steps(
                model, assets, body_model.faces, cfg.LOSS, only_seg=bool(args.only_seg),
                tripwire=tripwire)
            eval_metric = "garment_msre" if not args.only_seg else "total_loss"

        if args.only_eval:
            if args.vis and main_process:
                _export_predictions(args, model, eval_batches(0), assets, body_model, logger)
            means = eval_one_epoch(state, eval_batches(0), eval_step, logger=logger)
            logger.info(f"EVAL RESULT: {eval_metric}={means.get(eval_metric):.6f}")
            if main_process:
                print({k: round(v, 6) for k, v in sorted(means.items())})
            return means

        def save_fn(st, epoch, best):
            ckpt_lib.save_on_main(ckpt_path, st, epoch, {"best_v_l2": best})

        state, history = fit(
            state, train_batches, eval_batches, train_step, eval_step,
            epochs=args.epoch_num, output_dir=args.output_dir if main_process else None,
            use_plateau=bool(args.lr_sche), eval_metric=eval_metric,
            save_fn=save_fn, logger=logger, start_epoch=start_epoch, best=best)
        return history
    finally:
        for loader in loaders:
            loader.close()
        if tripwire is not None:
            tripwire.close()


@torch.inference_mode()
def _export_predictions(args, model, batches, assets, body_model, logger,
                        max_batches: int = 2) -> None:
    """--vis: each frame of the first `max_batches` eval batches written
    under <output_dir>/vis by `export_frame`, tagged b{batch}_s{row}_f{frame}:
    the point cloud coloured by the predicted segmentation, the predicted
    garment (the last refinement iteration; the canonical stage's T-pose
    garment, one frame), the ground truth and the body."""
    vis_dir = os.path.join(args.output_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    model.eval()
    for bi, batch in enumerate(batches):
        if bi >= max_batches:
            break
        if args.GarmentPCALBS:
            out = model(batch["pcd"], body_inputs_from_batch(batch))
            pred = out.iter_garment_v[-1]  # (B, T, Vg, 3)
            logits = out.canonical.backbone.sem_logits
            gt = batch["garment"]  # (B, T, Vg, 3)
        else:
            out = model(batch["pcd"])
            pred = out.tpose_garment[:, None]  # (B, 1, Vg, 3)
            logits = out.backbone.sem_logits
            gt = batch["garment_template_vertices"][:, None]  # (B, 1, Vg, 3)
        pcd = batch["pcd"].cpu().numpy()
        B, T = pcd.shape[:2]
        labels = logits.argmax(-1).reshape(B, T, -1).cpu().numpy()
        pred, gt = pred.cpu().numpy(), gt.cpu().numpy()
        body = batch["smpl_vertices"].cpu().numpy()
        for b in range(B):
            for t in range(min(T, pred.shape[1])):
                export_frame(vis_dir, f"b{bi}_s{b}_f{t}",
                             {"pcd": pcd[b, t], "pcd_labels": labels[b, t],
                              "pred_garment": pred[b, t], "gt_garment": gt[b, t],
                              "body": body[b, t]},
                             garment_faces=assets.faces_tri, body_faces=body_model.faces)
    logger.info(f"wrote visualisations to {vis_dir}")


if __name__ == "__main__":
    main()
