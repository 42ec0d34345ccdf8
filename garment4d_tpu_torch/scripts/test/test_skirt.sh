#!/usr/bin/env bash
# Evaluation of the posed stage from a pretrained checkpoint (a port
# checkpoint, a Flax npz or the reference's .ckpt) on the port's entry point.
# Add --vis to write the first two eval batches' predictions under
# <output_dir>/vis.
set -e
cd "$(dirname "$0")/../../.."
python -m garment4d_tpu_torch.train_temporal \
    --config cfgs/skirt.yaml \
    --GarmentPCALBS 1 \
    --only_eval 1 \
    --pretrained_model pretrain/skirt.ckpt \
    --batch_size 4 \
    --T 10 \
    --npoints 6890 \
    --output_dir ./output/skirt_eval \
    "$@"
