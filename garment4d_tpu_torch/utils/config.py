"""Typed configuration and command line, on the reference's YAML schema.

Counterpart of `garment4d_tpu/utils/config.py`: the same `cfgs/*.yaml`
schema (GARMENT / NETWORK / DATASET / LOSS sections, `_BASE_CONFIG_` merges)
loads into dataclasses, `LOSS` onto the port's `losses.LossWeights`, and
`build_arg_parser` has the same flags and defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import yaml

from garment4d_tpu_torch.losses import LossWeights


@dataclasses.dataclass
class GarmentConfig:
    NAME: str = "Skirt"
    TEMPLATE: str = "Skirt_template.obj"
    PCACOMPONENTSFILE: str = "PCABase_SS.pkl"
    PCADIM: int = 64


@dataclasses.dataclass
class NetworkConfig:
    LBSK: int = 256
    ITERATION: int = 3
    NPOINTS: int = 6890


@dataclasses.dataclass
class DatasetConfig:
    ROOT_FOLDER: str = "./dataset/CLOTH3D"
    GARMENT_FOLDER: str = "Skirt_reg"
    CLOTH3D_FOLDER: str = "CLOTH3D"
    GARMENT_TEMPLATE_T_POSE_PREFIX: str = "CLOTH3D_template"
    TRAIN_F_LIST: str = ""
    EVAL_F_LIST: str = ""
    EXCLUDE_SEQ_LIST: str = ""
    # resolved path helpers (filled by load_config, parity with
    # reference `utils/config.py:122-125`)
    SMPL_PARAM_PREFIX: str = ""


@dataclasses.dataclass
class Config:
    GARMENT: GarmentConfig = dataclasses.field(default_factory=GarmentConfig)
    NETWORK: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    DATASET: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    LOSS: LossWeights = dataclasses.field(default_factory=LossWeights)


_LOSS_KEY_MAP = {
    "SEM_SEG_LOSS_LAMBDA": "sem_seg",
    "GARMENT_L2_LOSS_LAMBDA": "garment_l2",
    "GARMENT_LAP_LOSS_LAMBDA": "garment_lap",
    "INTERPENETRATION_LOSS_LAMBDA": "interpenetration",
    "GARMENT_PCA_COEFF_L2_LAMBDA": "garment_pca_coeff_l2",
    "LBS_GARMENT_L2_LOSS_LAMBDA": "lbs_garment_l2",
    "LBS_GARMENT_LAP_LOSS_LAMBDA": "lbs_garment_lap",
    "LBS_INTERPENETRATION_LOSS_LAMBDA": "lbs_interpenetration",
    "TEMPORAL_CONSTRAINT_LOSS_LAMBDA": "temporal_constraint",
}


def _load_yaml_with_base(path: str) -> dict:
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    if "_BASE_CONFIG_" in raw:
        base = _load_yaml_with_base(raw.pop("_BASE_CONFIG_"))
        for k, v in raw.items():
            if isinstance(v, dict) and isinstance(base.get(k), dict):
                base[k].update(v)
            else:
                base[k] = v
        return base
    return raw


def load_config(path: str) -> Config:
    raw = _load_yaml_with_base(path)
    cfg = Config()
    for section_name, section in (("GARMENT", cfg.GARMENT),
                                  ("NETWORK", cfg.NETWORK),
                                  ("DATASET", cfg.DATASET)):
        for k, v in (raw.get(section_name) or {}).items():
            if hasattr(section, k):
                setattr(section, k, v)
    loss_kwargs = {}
    for k, v in (raw.get("LOSS") or {}).items():
        if k in _LOSS_KEY_MAP:
            loss_kwargs[_LOSS_KEY_MAP[k]] = float(v)
    cfg.LOSS = LossWeights(**loss_kwargs)

    # path join post-processing (reference `utils/config.py:122-125`)
    d = cfg.DATASET
    cfg.GARMENT.TEMPLATE = os.path.join(d.ROOT_FOLDER, d.GARMENT_FOLDER,
                                        cfg.GARMENT.TEMPLATE)
    cfg.GARMENT.PCACOMPONENTSFILE = os.path.join(d.ROOT_FOLDER, d.GARMENT_FOLDER,
                                                 cfg.GARMENT.PCACOMPONENTSFILE)
    d.SMPL_PARAM_PREFIX = os.path.join(d.ROOT_FOLDER, d.CLOTH3D_FOLDER)
    d.GARMENT_TEMPLATE_T_POSE_PREFIX = os.path.join(
        d.ROOT_FOLDER, d.GARMENT_TEMPLATE_T_POSE_PREFIX)
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX package's flag surface, flags and defaults alike. The entry
    point (`garment4d_tpu_torch.train_temporal`) refuses the flags whose
    modules the port does not have yet."""
    p = argparse.ArgumentParser(description="Garment4D (PyTorch)")
    p.add_argument("--config", type=str, default="cfgs/default.yaml")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--epoch_num", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_sche", action="store_true", default=False)
    p.add_argument("--npoints", type=int, default=4096)
    p.add_argument("--output_dir", type=str, default="./output/smpl_n1")
    p.add_argument("--ckpt_name", type=str, default="model.ckpt")
    p.add_argument("--launcher", type=str, default=None)
    p.add_argument("--tcp_port", type=int, default=12345)
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--syncbn", type=int, default=0)
    p.add_argument("--pretrained_model", type=str, default=None)
    p.add_argument("--vis", action="store_true", default=False)
    p.add_argument("--T", type=int, default=20)
    p.add_argument("--GarmentPCA", type=int, default=0)
    p.add_argument("--GarmentPCALBS", type=int, default=0)
    p.add_argument("--GarmentPCA_pretrain", type=str, default=None)
    p.add_argument("--fix_PCA", type=int, default=0)
    p.add_argument("--only_seg", type=int, default=0)
    p.add_argument("--MGN", type=int, default=0)
    p.add_argument("--only_eval", type=int, default=0)
    p.add_argument("--smpl_model_dir", type=str, default="smplx/models",
                   help="directory with SMPL_{MALE,FEMALE}.{pkl,npz}")
    p.add_argument("--synthetic_data", type=int, default=0,
                   help="use the synthetic fixture dataset (no CLOTH3D needed)")
    p.add_argument("--bf16", type=int, default=0,
                   help="bf16 computation for the encoder dense stacks (params/geometry stay f32)")
    p.add_argument("--remat", type=int, default=0,
                   help="rematerialise posed-stage PE blocks in the backward (fits batch>=8 training in HBM)")
    p.add_argument("--spatial_sample", type=int, default=0,
                   help="Morton-ordered neighbourhood sampling for the posed-stage "
                        "refinement queries (faster; a different but equally "
                        "arbitrary in-radius subset - from-scratch training only, "
                        "not checkpoint-parity eval)")
    p.add_argument("--candidate_reuse_margin", type=float, default=0.0,
                   help="> 0: reuse the posed-stage body-query candidate "
                        "compaction across refinement iterations while the "
                        "garment verts move less than this margin (exact; "
                        "rebuilds on drift - pays off with trained weights)")
    p.add_argument("--debug_nans", type=int, default=0,
                   help="stop at the first NaN (JAX's jax_debug_nans; no "
                        "counterpart in the port)")
    return p


def parse_args(argv=None):
    args = build_arg_parser().parse_args(argv)
    cfg = load_config(args.config)
    return args, cfg
