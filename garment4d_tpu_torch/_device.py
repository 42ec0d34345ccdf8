"""The device an entry point runs on.

Entry points (`GarmentReconstructor.from_assets`/`from_npz`, `make_batch`,
`template_pose`, `synthetic_smpl`, the post-processing and fitting tools)
default to the card. A caller who wants
the plain torch versions on the CPU asks for them with `device="cpu"`;
without a card, the default raises instead of running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no CUDA
    device is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is false; "
            f"pass device='cpu' to run the plain torch versions on the CPU")
    return dev


def tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """`x` (a numpy array, a list or a tensor) as a tensor of `dtype` on
    `device`, detached."""
    if torch.is_tensor(x):
        return x.detach().to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)
