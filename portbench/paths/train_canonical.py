"""The canonical stage's training recipe
(`scripts/train/train_skirt_canonical.sh`): `make_canonical_steps`' train
step from the canonical weights of the file, BatchNorm on batch
statistics, the head's dropout drawn from a generator on the device
seeded from the run's seed, Adam at the workload's rate, the loss
scalars copied to the host each step."""

from __future__ import annotations

import torch

from portbench import inputs, program
from portbench.reference.network import Net
from portbench.training import TrainJob

KIND = "train"


class Job(TrainJob):
    kind = "canonical"

    def __init__(self, cell, seed: int, device, fault=None):
        super().__init__(cell, seed, device, fault)
        from garment4d_tpu_torch.models import CanonicalGarmentModel
        from garment4d_tpu_torch.train import (load_npz_subtree, make_canonical_steps,
                                               make_state_for)

        c = cell.config
        assets = program.assets(cell.template, c["garment"])
        model = CanonicalGarmentModel(assets).to(self.device)
        model.load_state_dict(load_npz_subtree(cell.weights, "canonical"), strict=True)
        self.state = make_state_for(model, lr=self.lr)
        train, evaluate = make_canonical_steps(model, assets, cell.body["faces"])
        self.dropout_seed = inputs.derive(seed, inputs.DROPOUT)
        generator = torch.Generator(device=self.device).manual_seed(self.dropout_seed)
        self.train_step = lambda batch: train(self.state, batch, generator)
        self.eval_step = lambda batch: evaluate(self.state, batch)

    def reference_generator(self):
        return torch.Generator(device=self.device).manual_seed(self.dropout_seed)

    def reference(self) -> Net:
        return Net.of(self.cell, self.device, canonical_only=True)
