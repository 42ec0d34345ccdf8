"""The train cells' shared harness: one training object driven from the
seed through its first steps in set-up, then by the window; the readings
the reference follows (each step's losses, the first gradient as Adam got
it, the change of the trained tensors over the first three steps).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench import compare, inputs, program
from portbench.reference import train as ref_train
from portbench.reference.network import Net, tf32

FOLLOWED = 3        # set-up steps the reference follows
FAULTS = ("unchanged", "half_batch")


def host_scalars(losses: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The 0-d losses in one copy to the host, as the port's epoch loop
    (`train/loop.py:host_scalars`) takes them each step."""
    keys = [k for k, v in losses.items() if v.ndim == 0]
    vals = torch.stack([losses[k].detach().to(torch.float64) for k in keys]).tolist()
    return dict(zip(keys, vals))


def half(batch: dict) -> dict:
    """The first half of a batch's sequences."""
    h = batch["pose"].shape[0] // 2
    return {k: v[:h] for k, v in batch.items()}


class TrainJob:
    """Subclasses build `self.state` (the port's TrainState),
    `self.train_step(batch)` and `self.eval_step(batch)` (the fault of a
    step that leaves its state unchanged), `reference()`, and name their
    `kind` ("posed" or "canonical")."""

    kind = ""
    first_window_step = FOLLOWED

    def __init__(self, cell, seed: int, device, fault=None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"{self.kind}: no fault {fault!r}")
        self.cell, self.seed, self.device, self.fault = cell, seed, torch.device(device), fault
        c, w = cell.config, cell.workload
        self.body = inputs.body_on(cell.body, self.device)
        self.pool = [inputs.make_batch(cell.template, c["garment_label"], self.body,
                                       batch_size=w["batch"], T=w["frames"], npoints=w["points"],
                                       seed=inputs.derive(seed, inputs.POOL, i), device=self.device)
                     for i in range(w["pool"])]
        if w["pool"] < FOLLOWED:
            raise ValueError("the pool holds fewer batches than the steps followed")
        self.frames = w["batch"] * w["frames"]
        self.lr = w["lr"]
        self.losses: List[Dict[str, float]] = []

    def trained(self) -> Dict[str, torch.Tensor]:
        """The trained tensors in the Flax layout, by Flax path (copies)."""
        out = {}
        for name, p in self.state.model.named_parameters():
            if p.requires_grad:
                key, value = program.flax_name(name, p.detach())
                out[key] = value.clone()
        return out

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """The first step's gradient as Adam got it: its first moment after
        one step over (1 - beta1)."""
        out = {}
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        for name, p in self.state.model.named_parameters():
            if p.requires_grad:
                moment = self.state.optimizer.state.get(p, {}).get("exp_avg")
                key, m = program.flax_name(name, torch.zeros_like(p) if moment is None
                                           else moment)
                out[key] = m / (1.0 - beta1)
        return out

    def warmup(self):
        self.start = self.trained()
        for i in range(FOLLOWED):
            self.step(i)
            if i == 0:
                self.grads = self.first_gradient()
        self.end = self.trained()

    def step(self, i: int) -> bool:
        batch = self.pool[i % len(self.pool)]
        if self.fault == "half_batch":
            batch = half(batch)
        run = self.eval_step if self.fault == "unchanged" else self.train_step
        scalars = host_scalars(run(batch))
        if i < FOLLOWED:
            self.losses.append(scalars)
        return all(math.isfinite(v) for v in scalars.values())

    def release(self):
        del self.state, self.train_step, self.eval_step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> Net:
        raise NotImplementedError

    def reference_generator(self):
        return None

    def check(self, control=None):
        """-> (the compared numbers, with `control` those of a stand-in for
        the program, else None). `control`: "tf32", the reference computed
        with TF32 products; "ulp", the reference started from trained
        tensors one float32 ulp above the file's (a witness of how far
        rounding alone carries the readings)."""
        batches = self.pool[:FOLLOWED]

        def follow(nudge=False):
            net = self.reference()
            if nudge:
                for n in ref_train.trained_names(net, self.kind):
                    net.W[n] = torch.nextafter(net.W[n], torch.full_like(net.W[n], math.inf))
            r = ref_train.steps(net, self.kind, batches, self.lr, self.reference_generator())
            r["end"] = {n: net.W[n].detach() for n in r["start"]}
            return r

        ref = follow()
        port = {"losses": self.losses, "grads": self.grads, "start": self.start,
                "end": self.end}
        numbers = compare.train_numbers(port, ref)
        if control is None:
            return numbers, None
        if control == "tf32":
            with tf32():
                low = follow()
        elif control == "ulp":
            low = follow(nudge=True)
        else:
            raise ValueError(f"no control {control!r}")
        return numbers, compare.train_numbers(low, ref)
