"""Training utilities: Flax checkpoint conversion, batch -> model inputs."""

from garment4d_tpu_torch.train.convert import flax_to_torch, load_npz, load_npz_subtree
from garment4d_tpu_torch.train.step import body_inputs_from_batch

__all__ = ["body_inputs_from_batch", "flax_to_torch", "load_npz", "load_npz_subtree"]
