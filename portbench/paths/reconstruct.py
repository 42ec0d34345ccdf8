"""`GarmentReconstructor.posed` on batches back to back, each batch's
garment copied to the host (a user who writes the meshes needs it).

Correctness: the outputs of the last pass over a seed-drawn sample of the
pool's batches (segmentation logits, PCA coefficients, the LBS garment,
every refinement's garment) against the plain reference run on the same
batches after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare, inputs, program
from portbench.reference.network import Net, tf32

KIND = "reconstruct"
WARMUP = 2
FAULTS = ("half_batch", "altered", "one_frame")


class Job:
    def __init__(self, cell, seed: int, device, fault=None):
        from garment4d_tpu_torch.api import GarmentReconstructor

        if fault not in (None,) + FAULTS:
            raise ValueError(f"reconstruct: no fault {fault!r}")
        self.cell, self.device, self.fault = cell, torch.device(device), fault
        c, w = cell.config, cell.workload
        self.body = inputs.body_on(cell.body, self.device)
        self.recon = GarmentReconstructor.from_npz(
            program.assets(cell.template, c["garment"]), program.body_model(self.body),
            cell.weights, device=self.device, lbs_k=c["lbs_k"])
        self.pool = [inputs.make_batch(cell.template, c["garment_label"], self.body,
                                       batch_size=w["batch"], T=w["frames"], npoints=w["points"],
                                       seed=inputs.derive(seed, inputs.POOL, i), device=self.device)
                     for i in range(w["pool"])]
        self.body_in = [program.body_inputs(b) for b in self.pool]
        rng = np.random.default_rng(inputs.derive(seed, inputs.SAMPLE))
        self.checked = sorted(int(k) for k in rng.choice(w["pool"], w["checked"], replace=False))
        self.kept = {}
        self.frames = w["batch"] * w["frames"]

    first_window_step = WARMUP

    def warmup(self):
        for i in range(WARMUP):
            self.step(i)

    @torch.inference_mode()
    def _forward(self, k):
        pcd, body = self.pool[k]["pcd"], self.body_in[k]
        if self.fault != "half_batch":
            out = self.recon.posed(pcd, body, return_all=True)
        else:  # the second half of the sequences left out, the first half's answers in its place
            h = pcd.shape[0] // 2
            half = type(body)(**{f: getattr(body, f)[:h] for f in body.__dataclass_fields__})
            out = self.recon.posed(pcd[:h], half, return_all=True)
            out = _tile(out, pcd.shape[0])
        if self.fault == "altered":  # one sequence's garment moved 1 mm where it is produced
            out.iter_garment_v[-1][0, :, :, 0] += 1e-3
        elif self.fault == "one_frame":  # every sequence's last frame moved 1 mm
            out.iter_garment_v[-1][:, -1, :, 0] += 1e-3
        return out

    def step(self, i: int) -> bool:
        k = i % len(self.pool)
        out = self._forward(k)
        garment = out.iter_garment_v[-1].cpu()
        if k in self.checked:
            self.kept[k] = out
        return bool(torch.isfinite(garment).all())

    def release(self):
        del self.recon
        self.kept = {k: _outputs(o) for k, o in self.kept.items()}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> Net:
        return Net.of(self.cell, self.device)

    def check(self, control=None):
        """-> (the compared numbers, with `control` "tf32" those of the
        reference computed with TF32 products in the program's place, else
        None)."""
        if control not in (None, "tf32"):
            raise ValueError(f"no control {control!r}")
        net = self.reference()
        ref, low = [], []
        with torch.no_grad():
            for k in self.checked:
                batch = self.pool[k]
                ref.append(_outputs_ref(net.posed(batch["pcd"], batch)))
                if control:
                    with tf32():
                        low.append(_outputs_ref(net.posed(batch["pcd"], batch)))
        port = [self.kept[k] for k in self.checked]
        return (compare.reconstruct_numbers(port, ref),
                compare.reconstruct_numbers(low, ref) if control else None)


def _tile(out, B):
    """A PosedOutput over the first B // 2 sequences made to stand for all
    B: the first half's answers repeated in the second half's place."""
    from garment4d_tpu_torch.models.posed import PosedOutput

    def rep(t, rows):
        return torch.cat([t, t[: rows - t.shape[0]]], 0)

    T = out.lbs.posed_garment.shape[1]
    canon = out.canonical
    backbone = canon.backbone._replace(sem_logits=rep(canon.backbone.sem_logits, B * T))
    canon = canon._replace(backbone=backbone, pca_coeff=rep(canon.pca_coeff, B))
    lbs = out.lbs._replace(posed_garment=rep(out.lbs.posed_garment, B))
    return PosedOutput(canonical=canon, lbs=lbs,
                       iter_garment_v=tuple(rep(v, B) for v in out.iter_garment_v))


def _outputs(out) -> dict:
    return {"logits": out.canonical.backbone.sem_logits, "coeff": out.canonical.pca_coeff,
            "lbs": out.lbs.posed_garment, "iters": list(out.iter_garment_v)}


def _outputs_ref(out) -> dict:
    return {"logits": out["sem_logits"], "coeff": out["pca_coeff"], "lbs": out["lbs"],
            "iters": out["iters"]}
