"""Training: Flax checkpoint conversion, the train and eval steps of both
stages, optimizer state and the plateau schedule; the epoch loop
(`train/loop.py`) and checkpoints (`train/checkpoint.py`)."""

from garment4d_tpu_torch.train.convert import flax_to_torch, load_npz, load_npz_subtree
from garment4d_tpu_torch.train.state import PlateauScheduler, TrainState, make_optimizer
from garment4d_tpu_torch.train.step import (
    body_inputs_from_batch,
    make_canonical_steps,
    make_posed_steps,
    make_state_for,
)

__all__ = ["PlateauScheduler", "TrainState", "body_inputs_from_batch", "flax_to_torch",
           "load_npz", "load_npz_subtree", "make_canonical_steps", "make_optimizer",
           "make_posed_steps", "make_state_for"]
