"""Garment assets and models."""

from garment4d_tpu_torch.models.assets import CLASS_NUM, LABEL_DICT, GarmentAssets
from garment4d_tpu_torch.models.backbone import BackboneOutput, PointNet2SegBackbone
from garment4d_tpu_torch.models.canonical import (
    CanonicalGarmentModel,
    CanonicalOutput,
    select_garment_points,
)
from garment4d_tpu_torch.models.mgn import MgnGarmentModel
from garment4d_tpu_torch.models.posed import BodyInputs, LeverState, PosedGarmentModel, PosedOutput
from garment4d_tpu_torch.models.skinning import (
    LbsResult,
    lbs_garment_interpolation,
    lbs_garment_single_nn,
)

__all__ = [
    "BackboneOutput", "BodyInputs", "CLASS_NUM", "CanonicalGarmentModel",
    "CanonicalOutput", "GarmentAssets", "LABEL_DICT", "LbsResult", "LeverState", "MgnGarmentModel",
    "PointNet2SegBackbone", "PosedGarmentModel", "PosedOutput",
    "lbs_garment_interpolation", "lbs_garment_single_nn", "select_garment_points",
]
