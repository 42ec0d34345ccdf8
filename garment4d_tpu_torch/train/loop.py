"""Training driver: epoch loops, metric accumulation, logging, best-checkpoint
save.

Counterpart of `garment4d_tpu/train/loop.py` (reference `train_temporal.py`
build / train_one_epoch / eval_one_epoch / main loops):

  * one train step per batch, `train_step(state, batch, generator)`, which
    updates `state` in place and returns its loss dict; the scalars come to
    the host in one copy per step and are summed there;
  * TensorBoard scalars with the reference's tag scheme (`Train/{j:02d}_{k}`,
    `LR`, `Eval/01_v_sqrt_l2_loss`, `train_temporal.py:273-278,351`) and the
    same lines in `metrics.jsonl`;
  * ReduceLROnPlateau stepped once an epoch with the eval metric, and the
    best checkpoint saved on eval improvement (`train_temporal.py:394-405`).

The dropout of every step draws from one `torch.Generator` on the model's
device, seeded from `seed` (the JAX package splits a `jax.random` key a
step).

In a process group (data parallelism) every rank runs the loop on its
share of each global batch: the train steps return global means already,
the eval means are reduced over the ranks as weighted global sums (a rank
whose share of the eval tail is all padding weighs 0), so the plateau step
and the "new best" decision are the same on every rank, and only rank 0
writes the scalars.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from garment4d_tpu_torch.parallel.data import reduce_metric_sums
from garment4d_tpu_torch.parallel.launch import in_group, is_main_process
from garment4d_tpu_torch.train.state import PlateauScheduler, TrainState


def make_logger(output_dir: Optional[str] = None, name: str = "garment4d_tpu_torch"):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricWriter:
    """TensorBoard (where `torch.utils.tensorboard` imports) and JSONL
    scalar writer."""

    def __init__(self, output_dir: Optional[str]):
        self._tb = None
        self._jsonl = None
        if output_dir:
            os.makedirs(os.path.join(output_dir, "summary"), exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(output_dir, "summary"))
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


def host_scalars(loss_dict: Dict[str, torch.Tensor], *extra: torch.Tensor):
    """-> ({key: float} of the 0-d entries of `loss_dict`, [float of each
    of `extra`]), exact (float64 holds every float32), in one copy to the
    host for all of them."""
    keys = [k for k, v in loss_dict.items() if v.ndim == 0]
    vals = [loss_dict[k] for k in keys] + list(extra)
    if not vals:
        return {}, []
    dev = vals[0].device
    host = torch.stack([v.detach().to(dev, torch.float64) for v in vals]).tolist()
    return dict(zip(keys, host)), host[len(keys):]


class MetricAccumulator:
    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.count = 0.0

    def add(self, scalars: Dict[str, float], weight: float = 1.0):
        """`scalars`: host floats. `weight` is the batch's valid-sample
        count where eval-tail padding masks are in play, so duplicated
        samples do not skew the dataset means."""
        for k, v in scalars.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * weight
        self.count += weight

    def means(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1e-12) for k, v in self.sums.items()}


def train_one_epoch(state: TrainState, batches: Iterable, train_step,
                    generator: torch.Generator, writer: Optional[MetricWriter] = None,
                    epoch: int = 0, logger=None):
    """Runs one epoch; returns (state, mean_losses). The `Train/*` scalars
    are written at the batch's index in its epoch, as the JAX package's
    `fit` writes them."""
    acc = MetricAccumulator()
    t0 = time.time()
    for i, batch in enumerate(batches):
        scalars, _ = host_scalars(train_step(state, batch, generator))
        acc.add(scalars)
        if writer is not None:
            for j, (k, v) in enumerate(sorted(scalars.items())):
                writer.scalar(f"Train/{j:02d}_{k}", v, i)
    means = acc.means()
    if logger is not None:
        span = time.time() - t0
        loss_str = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
        logger.info(f"epoch {epoch} train [{span:.1f}s] {loss_str}")
    return state, means


def eval_one_epoch(state: TrainState, batches: Iterable, eval_step,
                   writer: Optional[MetricWriter] = None, epoch: int = 0,
                   logger=None) -> Dict[str, float]:
    acc = MetricAccumulator()
    for batch in batches:
        # each batch weighs its valid-sample count, so padded tail
        # duplicates do not skew the dataset means (full batches weigh
        # their batch size, masked tail batches their real samples)
        mask = batch.get("valid_mask") if isinstance(batch, dict) else None
        loss_dict = eval_step(state, batch)
        if mask is not None:
            scalars, (weight,) = host_scalars(loss_dict, torch.as_tensor(mask).sum())
        else:
            scalars, _ = host_scalars(loss_dict)
            weight = (float(batch["pcd"].shape[0])
                      if isinstance(batch, dict) and "pcd" in batch else 1.0)
        acc.add(scalars, weight=weight)
    if in_group():
        acc.sums, acc.count = reduce_metric_sums(acc.sums, acc.count, _model_device(state))
    means = acc.means()
    if writer is not None:
        key = ("lbs_garment_msre" if "lbs_garment_msre" in means
               else "garment_msre" if "garment_msre" in means else "total_loss")
        writer.scalar("Eval/01_v_sqrt_l2_loss", means.get(key, 0.0), epoch)
    if logger is not None:
        loss_str = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
        logger.info(f"epoch {epoch} eval {loss_str}")
    return means


def _model_device(state: TrainState) -> torch.device:
    for t in state.model.parameters():
        return t.device
    return torch.device("cpu")


def fit(state: TrainState, train_batches_fn, eval_batches_fn, train_step,
        eval_step, *, epochs: int, output_dir: Optional[str] = None,
        use_plateau: bool = False, eval_metric: str = "total_loss",
        save_fn: Optional[Callable] = None, seed: int = 0, logger=None):
    """Full fit loop with the plateau learning-rate schedule and
    best-checkpoint saving.

    `train_batches_fn(epoch)` / `eval_batches_fn(epoch)` yield batch dicts;
    `save_fn(state, epoch, best)` persists the best checkpoint. Epochs count
    from 0 on every call, as in the JAX package, also after a resume.
    """
    logger = logger or make_logger(output_dir)
    writer = MetricWriter(output_dir if is_main_process() else None)
    plateau = PlateauScheduler()
    generator = torch.Generator(device=_model_device(state)).manual_seed(seed)
    best = float("inf")
    history = []
    try:
        for epoch in range(epochs):
            state, train_means = train_one_epoch(
                state, train_batches_fn(epoch), train_step, generator,
                writer=writer, epoch=epoch, logger=logger)
            eval_means = eval_one_epoch(
                state, eval_batches_fn(epoch), eval_step,
                writer=writer, epoch=epoch, logger=logger)
            metric = eval_means.get(eval_metric, eval_means.get("total_loss", 0.0))
            if use_plateau:
                state.lr_scale = plateau.update(metric)
                writer.scalar("LR", state.lr_scale, epoch)
            if metric < best:
                best = metric
                if save_fn is not None:
                    save_fn(state, epoch, best)
                logger.info(f"epoch {epoch}: new best {eval_metric}={best:.4f}")
            history.append({"epoch": epoch, "train": train_means, "eval": eval_means})
    finally:
        writer.close()
    return state, history
