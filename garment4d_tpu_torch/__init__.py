"""Garment4D in PyTorch with hand-written CUDA kernels for Hopper (H100).

A port of `garment4d_tpu` (JAX, Flax and Pallas), which stays in the repo as
the reference. The layout mirrors it module for module:
  ops/     - point-cloud, graph and mesh primitives: plain torch versions,
             and CUDA kernels (`ops/csrc/`, built with nvcc for sm_90a at
             first use)
  nn/      - BatchNorm'd dense blocks, PointNet++ SA/FP modules
  smpl/    - SMPL body model and linear blend skinning
  models/  - garment assets, segmentation backbone, canonical (PCA) model,
             interpolated LBS, posed (PCA + LBS + GCN) model
  data/    - synthetic batches; the CLOTH3D dataset, its file readers,
             loader threads and fixture writer
  train/   - train and eval steps, the epoch loop, checkpoints,
             Flax-checkpoint conversion
  utils/   - the YAML config and the command line
  api.py   - GarmentReconstructor (on the card unless asked for the CPU)
  train_temporal.py - the training entry point
             (`python -m garment4d_tpu_torch.train_temporal`)

This package imports torch and numpy only, never JAX.

Float32 throughout: TF32 is switched off for matmuls and cuDNN, so products
on the card run in full fp32 (the Hopper counterpart of the bf16-pass trap
that `garment4d_tpu/ops/pallas/precision.py` fixed on the TPU).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
