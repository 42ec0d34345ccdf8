"""Demos on the port: GCN node classification, PointNet++ segmentation
and the SMPL forward, each runnable as `python -m
garment4d_tpu_torch.demos.<name>` (on the card; `--cpu` for the CPU)."""
