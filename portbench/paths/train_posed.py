"""The posed stage's training recipe (`scripts/train/train_skirt_posed.sh`):
`make_posed_steps`' train step, the canonical stage frozen, Adam at the
workload's rate, the loss scalars copied to the host each step as the
port's epoch loop does."""

from __future__ import annotations

from portbench import program
from portbench.reference.network import Net
from portbench.training import TrainJob

KIND = "train"


class Job(TrainJob):
    kind = "posed"

    def __init__(self, cell, seed: int, device, fault=None):
        super().__init__(cell, seed, device, fault)
        from garment4d_tpu_torch.api import GarmentReconstructor
        from garment4d_tpu_torch.train import make_posed_steps, make_state_for

        c = cell.config
        assets = program.assets(cell.template, c["garment"])
        model = GarmentReconstructor.from_npz(assets, program.body_model(self.body),
                                              cell.weights, device=self.device,
                                              lbs_k=c["lbs_k"]).model
        self.state = make_state_for(model, lr=self.lr, freeze_canonical=True)
        train, evaluate = make_posed_steps(model, assets, cell.body["faces"])
        self.train_step = lambda batch: train(self.state, batch)
        self.eval_step = lambda batch: evaluate(self.state, batch)

    def reference(self) -> Net:
        return Net.of(self.cell, self.device)
