#!/usr/bin/env bash
# Posed-stage training, skirt, on the port's entry point; the canonical
# encoder from stage 1, frozen. Opt-in levers: --spatial_sample 1,
# --candidate_reuse_margin M.
set -e
cd "$(dirname "$0")/../../.."
python -m garment4d_tpu_torch.train_temporal \
    --config cfgs/skirt.yaml \
    --GarmentPCALBS 1 \
    --fix_PCA 1 \
    --GarmentPCA_pretrain ./output/skirt_canonical/ckpt/model.ckpt \
    --batch_size 4 \
    --lr 1e-3 \
    --lr_sche \
    --epoch_num 100 \
    --T 10 \
    --npoints 6890 \
    --output_dir ./output/skirt_posed \
    "$@"
