"""High-level inference API.

Counterpart of `GarmentReconstructor` in `garment4d_tpu/api.py`, built on
the posed-stage model (the flagship):

    recon = GarmentReconstructor.from_npz(assets, body_model,
                                          "ckpt_synth/posed_synth.npz")
    posed = recon.posed(pcd, body)   # (B, T, Vg, 3) per-frame garment
    garment = recon.canonical(pcd)   # (B, Vg, 3) T-pose garment
    labels = recon.segment(pcd)      # (B, T, N) 0-based classes

It runs on the card unless `device="cpu"` asks for the plain torch versions
on the CPU; without a card, the default raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.models import (
    BodyInputs,
    CanonicalGarmentModel,
    CanonicalOutput,
    GarmentAssets,
    PosedGarmentModel,
    PosedOutput,
)
from garment4d_tpu_torch.smpl import SmplModel
from garment4d_tpu_torch.train.convert import load_npz


@dataclasses.dataclass
class GarmentReconstructor:
    assets: GarmentAssets
    model: PosedGarmentModel
    device: torch.device

    @classmethod
    def from_assets(cls, assets: GarmentAssets, body_model: SmplModel,
                    device=_device.DEFAULT, state_dict: Optional[dict] = None,
                    lbs_k: int = 256) -> "GarmentReconstructor":
        """An eval-mode posed model on `device`, with `state_dict` loaded
        strictly when given (random init otherwise)."""
        device = _device.resolve(device)
        model = PosedGarmentModel(assets, body_model.faces, lbs_k=lbs_k)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        return cls(assets=assets, model=model.to(device).eval(), device=device)

    @classmethod
    def from_npz(cls, assets: GarmentAssets, body_model: SmplModel, path: str,
                 device=_device.DEFAULT, **kwargs) -> "GarmentReconstructor":
        """Load the whole variable tree of a Flax variables npz (such as
        `ckpt_synth/posed_synth.npz`)."""
        return cls.from_assets(assets, body_model, device, load_npz(path), **kwargs)

    @property
    def canonical_model(self) -> CanonicalGarmentModel:
        return self.model.canonical

    def _body(self, body: BodyInputs) -> BodyInputs:
        return BodyInputs(**{f.name: getattr(body, f.name).to(self.device)
                             for f in dataclasses.fields(body)})

    @torch.inference_mode()
    def run(self, pcd: torch.Tensor) -> CanonicalOutput:
        """pcd (B, T, N, 3) -> the canonical stage's full output."""
        return self.canonical_model(pcd.to(self.device, torch.float32))

    @torch.inference_mode()
    def posed(self, pcd: torch.Tensor, body: BodyInputs, return_all: bool = False):
        """pcd (B, T, N, 3) + body inputs -> the posed garment (B, T, Vg, 3)
        of the last refinement iteration, or the full PosedOutput with
        `return_all`."""
        out: PosedOutput = self.model(pcd.to(self.device, torch.float32),
                                      self._body(body))
        return out if return_all else out.iter_garment_v[-1]

    def canonical(self, pcd: torch.Tensor) -> torch.Tensor:
        """pcd (B, T, N, 3) -> canonical T-pose garment (B, Vg, 3)."""
        return self.run(pcd).tpose_garment

    def segment(self, pcd: torch.Tensor) -> torch.Tensor:
        """Per-point semantic labels (B, T, N), 0-based classes."""
        B, T = pcd.shape[:2]
        out = self.run(pcd)
        return out.backbone.sem_logits.argmax(-1).reshape(B, T, -1)
