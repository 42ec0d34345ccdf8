"""Batch -> model inputs for the posed stage.

Counterpart of `body_inputs_from_batch` in `garment4d_tpu/train/step.py`;
the train and eval steps wait for the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from garment4d_tpu_torch.models.posed import BodyInputs


def body_inputs_from_batch(batch: Dict[str, torch.Tensor]) -> BodyInputs:
    return BodyInputs(
        pose=batch["pose"],
        smpl_vertices=batch["smpl_vertices"],
        tpose_vertices=batch["tpose_smpl_vertices"],
        tpose_root_joints=batch["tpose_smpl_root_joints"],
        zeropose_vertices=batch["zeropose_smpl_vertices"],
        J_regressor=batch["J_regressor"],
        lbs_weights=batch["lbs_weights"],
    )
