"""PointNet++ segmentation demo on synthetic shapes.

Counterpart of `demos/pointcloud_seg_demo.py` (the reference's vendored
KITTI foreground-segmentation harness,
`modules/pointnet2/tools/train_and_eval.py`): the port's
`PointNet2SegBackbone` with a 2-class head, trained in train mode (batch
statistics, the head's dropout) with Adam at 1e-3 on a generated two-class
set: points on a sphere of radius 0.5 are class 1, Gaussian noise class 0.
On the card (`--cpu` for the CPU) a step runs the port's kernels: FPS, the
flat ball query, the row gather and its scatter-add backward, 3-NN. The
batches are the JAX demo's, drawn from `RandomState(0)` (the first one
only fixes the shapes, as the JAX demo's init batch does). Gate: accuracy
above 0.8 on the last step's batch.

Usage: python -m garment4d_tpu_torch.demos.pointcloud_seg_demo [--steps 30]
           [--npoints 2048] [--batch 2] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.losses import sem_seg_loss
from garment4d_tpu_torch.models.backbone import PointNet2SegBackbone


def make_batch(rng: np.random.RandomState, B: int, N: int):
    """The JAX demo's batch: (points (B, N, 3) float32, labels (B, N)
    int32), numpy; a third of the points on the sphere, in a random order."""
    n_fg = N // 3
    pts = rng.randn(B, N, 3).astype(np.float32)
    sphere = rng.randn(B, n_fg, 3)
    sphere /= np.linalg.norm(sphere, axis=-1, keepdims=True)
    pts[:, :n_fg] = sphere * 0.5
    labels = np.zeros((B, N), np.int32)
    labels[:, :n_fg] = 1
    perm = rng.permutation(N)
    return pts[:, perm], labels[:, perm]


def train(steps: int, npoints: int, batch: int, device, lr: float = 1e-3,
          log_every: int = 5, step_times=None):
    """Train from a seed-0 init on the JAX demo's batch stream: -> [(loss,
    accuracy)] a step, each read after its step. `step_times`: a list that
    gets each step's wall seconds (synchronised on the card)."""
    import time

    dev = _device.resolve(device)
    rng = np.random.RandomState(0)
    make_batch(rng, batch, npoints)  # the JAX demo's init batch
    torch.manual_seed(0)
    model = PointNet2SegBackbone(num_classes=2).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    history = []
    for i in range(steps):
        pts, labels = make_batch(rng, batch, npoints)
        t0 = time.perf_counter()
        pcd = torch.as_tensor(pts, device=dev)
        y = torch.as_tensor(labels, device=dev)
        generator = torch.Generator(device=dev).manual_seed(i)
        logits = model(pcd, generator).sem_logits
        loss = sem_seg_loss(logits, y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        acc = (logits.argmax(-1) == y).float().mean()
        history.append((loss.item(), acc.item()))
        if step_times is not None:
            step_times.append(time.perf_counter() - t0)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {history[-1][0]:.4f}  acc {history[-1][1]:.3f}", flush=True)
    return history


def main(argv=None, step_times=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--npoints", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    history = train(args.steps, args.npoints, args.batch,
                    "cpu" if args.cpu else _device.DEFAULT, step_times=step_times)
    if not history[-1][1] > 0.8:
        raise SystemExit(f"pointcloud_seg_demo: accuracy {history[-1][1]:.3f}; the demo "
                         f"should reach > 0.8")
    print("OK")
    return history


if __name__ == "__main__":
    main()
