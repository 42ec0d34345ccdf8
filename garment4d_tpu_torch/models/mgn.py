"""The MGN baseline variant of the posed stage (`--MGN 1`).

Counterpart of `garment4d_tpu/models/mgn.py` (reference
`modules/mesh_encoder.py:489-614`, PCALBSGarmentUseSegEncoderSegMGN): the
frozen canonical stage, a per-frame displacement MLP (512 -> 1024 -> 2048
-> Vg*3, scaled by 0.05, NaN set to 0) on the garment summary added to the
canonical garment, then single-nearest-neighbour LBS
(`lbs_garment_single_nn`): no interpolation, no smoothing, no GCN
refinement. Submodules are named by the Flax paths (`canonical`,
`displacement.linear0..2`), so a Flax variables npz loads through
`train/convert.py` and a reference checkpoint through
`train/torch_import.py`. In training only the displacement MLP learns:
the canonical stage runs in eval mode under no_grad, so its parameters get
no gradient and Adam leaves them as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from garment4d_tpu_torch.models.assets import GarmentAssets
from garment4d_tpu_torch.models.canonical import CanonicalGarmentModel, FrozenCanonicalStage
from garment4d_tpu_torch.models.posed import _SMPL_PARENTS, BodyInputs, PosedOutput
from garment4d_tpu_torch.models.skinning import lbs_garment_single_nn
from garment4d_tpu_torch.nn import MLP

SUMMARY_DIM = 512     # the canonical stage's garment summary
DISP_SCALE = 0.05     # reference `mesh_encoder.py:599`


class MgnGarmentModel(FrozenCanonicalStage):
    """MGN baseline: point-cloud sequence + body -> posed garment sequence
    through a displacement MLP and K=1 LBS. `body_faces` is accepted for
    symmetry with `PosedGarmentModel` and unused."""

    def __init__(self, assets: GarmentAssets, body_faces: np.ndarray = None):
        super().__init__()
        self.assets = assets
        self.canonical = CanonicalGarmentModel(assets)
        self.displacement = MLP(SUMMARY_DIM, (1024, 2048, assets.num_verts * 3))

    def forward(self, x: torch.Tensor, body: BodyInputs) -> PosedOutput:
        """x: (B, T, N, 3) point-cloud sequence."""
        B, T = x.shape[:2]
        Vg = self.assets.num_verts
        with torch.no_grad():  # stage 1 is frozen
            canonical = self.canonical(x)
        disp = self.displacement(canonical.garment_summary).reshape(B, T, Vg, 3) * DISP_SCALE
        disp = torch.where(torch.isnan(disp), torch.zeros_like(disp), disp)
        per_frame = canonical.tpose_garment[:, None] + disp  # (B, T, Vg, 3)
        lbs = lbs_garment_single_nn(
            per_frame, body.tpose_vertices, body.tpose_root_joints,
            body.zeropose_vertices, body.pose, body.J_regressor, body.lbs_weights,
            parents=_SMPL_PARENTS)
        return PosedOutput(canonical=canonical, lbs=lbs, iter_garment_v=(lbs.posed_garment,))
