#!/usr/bin/env bash
# Canonical-stage training, skirt, on the port's entry point (one GPU).
# Data-parallel over N GPUs: torchrun --nproc_per_node N -m
# garment4d_tpu_torch.train_temporal --launcher pytorch <the same flags>.
set -e
cd "$(dirname "$0")/../../.."
python -m garment4d_tpu_torch.train_temporal \
    --config cfgs/skirt.yaml \
    --GarmentPCA 1 \
    --batch_size 20 \
    --lr 1e-3 \
    --lr_sche \
    --epoch_num 100 \
    --T 10 \
    --npoints 6890 \
    --output_dir ./output/skirt_canonical \
    "$@"
