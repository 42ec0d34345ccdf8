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
  --only_eval 1      one evaluation pass

With --synthetic_data 1 it trains on synthetic batches (`data/synthetic.py`);
otherwise on the CLOTH3D tree the config names, read by `--num_workers`
loader threads and completed on the device (`data/cloth3d.py`). A
checkpoint at `<output_dir>/ckpt/<ckpt_name>` is resumed from. `main` runs
on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.data.cloth3d import (
    Cloth3dDataset,
    Cloth3dPaths,
    finalize_batch,
    host_to_device,
)
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
from garment4d_tpu_torch.train.step import make_canonical_steps, make_posed_steps, make_state_for
from garment4d_tpu_torch.utils.config import parse_args

# flags whose modules the port has not yet: (set?, ROADMAP item)
_UNPORTED = (
    (lambda a: a.vis, "--vis: the prediction export (data/export.py), ROADMAP Queue 1 item 7"),
    (lambda a: a.spatial_sample, "--spatial_sample 1: Morton-ordered sampling, "
                                 "ROADMAP Queue 1 item 6"),
    (lambda a: a.candidate_reuse_margin, "--candidate_reuse_margin: the body-query "
                                         "candidate reuse, ROADMAP Queue 1 item 6"),
    (lambda a: a.launcher, "--launcher: data parallelism (parallel/), ROADMAP Queue 1 item 5"),
    (lambda a: a.syncbn, "--syncbn 1: SyncBatchNorm (parallel/), ROADMAP Queue 1 item 5"),
    (lambda a: a.bf16, "--bf16 1: no counterpart in the port (fp32 throughout; ROADMAP)"),
    (lambda a: a.remat, "--remat 1: no counterpart in the port (ROADMAP)"),
    (lambda a: a.debug_nans, "--debug_nans 1: no counterpart in the port (ROADMAP)"),
)


def _refuse_unported(args) -> None:
    """Raise NotImplementedError for the first flag set whose module the
    port has not yet."""
    for is_set, what in _UNPORTED:
        if is_set(args):
            raise NotImplementedError(what)


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


def cloth3d_batches(args, cfg, npoints, body_models, device, logger, loaders):
    """(train_batches(epoch), eval_batches(epoch)) over the CLOTH3D tree:
    train windows shuffled by epoch with the last partial batch dropped,
    eval windows in order with the tail padded by repeats and masked out
    of the means by `valid_mask` (reference eval sampler,
    `utils/train_utils.py:12-31`). The loaders it makes are appended to
    `loaders`, for the caller to close."""
    paths = Cloth3dPaths(
        root=cfg.DATASET.ROOT_FOLDER,
        cloth3d_folder=cfg.DATASET.CLOTH3D_FOLDER,
        garment_folder=cfg.DATASET.GARMENT_FOLDER,
        template_prefix=cfg.DATASET.GARMENT_TEMPLATE_T_POSE_PREFIX)
    body_verts = body_models["male"].num_verts
    datasets = [Cloth3dDataset(
        paths, file_list, cfg.GARMENT.NAME, T=args.T, npoints=npoints,
        pca_dim=cfg.GARMENT.PCADIM, is_train=is_train,
        exclude_list=cfg.DATASET.EXCLUDE_SEQ_LIST or None, body_verts=body_verts)
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
                metas.append((idxs, mask if (not shuffle and n_real < bs) else None))
            for (_, mask), items in zip(metas, loader.map_batches([m[0] for m in metas])):
                batch = finalize_batch(ds.collate(items), body_models)
                if mask is not None:
                    batch["valid_mask"] = host_to_device(mask, device)
                yield batch
        return gen

    return make_gen(datasets[0], True, drop_last=True), make_gen(datasets[1], False, drop_last=False)


def _make_state(args, cfg, assets, body_model, device, logger):
    """The model on `device` with its weights (--pretrained_model, then the
    canonical bootstrap, both before the optimizer is built over the
    parameters left trainable), its train state, and the auto-resume from
    `<output_dir>/ckpt/<ckpt_name>` (reference build(),
    `train_temporal.py:136-156`; `fit` counts epochs from 0 again after
    it, as the JAX package's does)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the initial weights, as JAX's PRNGKey(0)
        if args.GarmentPCALBS and args.MGN:
            model = MgnGarmentModel(assets, body_model.faces)
        elif args.GarmentPCALBS:
            model = PosedGarmentModel(assets, body_model.faces, lbs_k=cfg.NETWORK.LBSK,
                                      iterations=cfg.NETWORK.ITERATION)
        else:
            model = CanonicalGarmentModel(assets, only_seg=bool(args.only_seg))
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
    ckpt_path = os.path.join(args.output_dir, "ckpt", args.ckpt_name)
    if os.path.isfile(ckpt_path) and not args.only_eval:
        state, start_epoch, other = ckpt_lib.restore_checkpoint(ckpt_path, state)
        logger.info(f"auto-resumed from {ckpt_path} at epoch {start_epoch} "
                    f"(best {other.get('best_v_l2')})")
    return state, ckpt_path


def main(argv=None, device=_device.DEFAULT):
    """Parse `argv` and train or evaluate; returns the fit history, or the
    eval means with --only_eval."""
    args, cfg = parse_args(argv)
    _refuse_unported(args)
    if not (args.GarmentPCA or args.GarmentPCALBS):
        raise SystemExit("select a stage: --GarmentPCA 1 or --GarmentPCALBS 1")
    if args.GarmentPCA_pretrain and not args.GarmentPCALBS:
        raise SystemExit("--GarmentPCA_pretrain bootstraps the posed stage: "
                         "pass --GarmentPCALBS 1")
    device = _device.resolve(device)

    os.makedirs(args.output_dir, exist_ok=True)
    logger = make_logger(args.output_dir)
    for key, val in sorted(vars(args).items()):
        logger.info(f"{key:20} {val}")

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

    loaders = []
    try:
        # ---------------- data ----------------
        if args.synthetic_data:
            def batches_fn(split_seed):
                def gen(epoch):
                    for i in range(2):
                        yield make_batch(assets, body_model, batch_size=args.batch_size,
                                         T=args.T, npoints=npoints,
                                         seed=split_seed * 1000 + epoch * 10 + i,
                                         device=device)
                return gen
            train_batches, eval_batches = batches_fn(0), batches_fn(1)
        else:
            train_batches, eval_batches = cloth3d_batches(
                args, cfg, npoints, body_models, device, logger, loaders)

        # ---------------- model, state, steps ----------------
        state, ckpt_path = _make_state(args, cfg, assets, body_model, device, logger)
        model = state.model
        if args.GarmentPCALBS:
            train_step, eval_step = make_posed_steps(model, assets, body_model.faces, cfg.LOSS)
            eval_metric = "lbs_garment_msre"
        else:
            train_step, eval_step = make_canonical_steps(
                model, assets, body_model.faces, cfg.LOSS, only_seg=bool(args.only_seg))
            eval_metric = "garment_msre" if not args.only_seg else "total_loss"

        if args.only_eval:
            means = eval_one_epoch(state, eval_batches(0), eval_step, logger=logger)
            logger.info(f"EVAL RESULT: {eval_metric}={means.get(eval_metric):.6f}")
            print({k: round(v, 6) for k, v in sorted(means.items())})
            return means

        def save_fn(st, epoch, best):
            ckpt_lib.save_checkpoint(ckpt_path, st, epoch, {"best_v_l2": best})

        state, history = fit(
            state, train_batches, eval_batches, train_step, eval_step,
            epochs=args.epoch_num, output_dir=args.output_dir,
            use_plateau=bool(args.lr_sche), eval_metric=eval_metric,
            save_fn=save_fn, logger=logger)
        return history
    finally:
        for loader in loaders:
            loader.close()


if __name__ == "__main__":
    main()
