"""Per-kernel device-time breakdown of the port's main paths on the card.

Usage: python -m garment4d_tpu_torch.tools.profile_posed [posed|canonical|train]
           [--iters N] [--batch N] [--top N] [--weights PATH|random] [--device cuda|cpu]

Counterpart of `garment4d_tpu/tools/profile_posed.py`, at its shapes: B=8
sequences (`--batch`) of T=10 frames of N=6890 points, the Vg=2000 ring
template, the 6890-vertex synthetic body, `lbs_k` 256, 3 refinement
iterations; `train` is the posed train step at B=4 (seed-1 batch, Adam at
1e-3, the canonical stage frozen). Weights: `ckpt_synth/posed_synth.npz`
by default (the query kernels' hit densities depend on the weights), its
`canonical/` subtree for `canonical`; `--weights random` keeps the seeded
init. Prints the step time and frames/s (median of `--iters` synchronised
steps after one warm-up), then the device ms a step by kernel from
torch.profiler (`utils.profiling.profile_device`, which holds the kernel
events against the port's launch counters), the total and the idle
share. With `--device cpu` the plain versions run on the CPU and the
table lists the CPU operators by self time.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from pathlib import Path

import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.utils.profiling import print_profile, profile_device

WHICH = ("posed", "canonical", "train")
DEFAULT_WEIGHTS = str(Path(__file__).resolve().parents[2] / "ckpt_synth" / "posed_synth.npz")
# the JAX tool's shapes
T, N, RINGS, RING_SIZE, LBS_K, ITERATIONS = 10, 6890, 125, 16, 256, 3
TRAIN_B, TRAIN_LR = 4, 1e-3


def build(which: str, batch: int = 8, weights=None, device=_device.DEFAULT, *,
          T: int = T, npoints: int = N, rings: int = RINGS, ring_size: int = RING_SIZE,
          body_verts: int = N, lbs_k: int = LBS_K, train_batch: int = TRAIN_B):
    """-> (step, frames a step, label of the weights): `step()` runs one
    call of path `which` at these sizes (the tool's defaults are the JAX
    tool's; a test shrinks them). `weights`: an npz of the posed model's
    variables, None for `DEFAULT_WEIGHTS` where it exists, or "random"."""
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import CanonicalGarmentModel, GarmentAssets
    from garment4d_tpu_torch.smpl import synthetic_smpl
    from garment4d_tpu_torch.train import (load_npz_subtree, make_posed_steps,
                                           make_state_for)
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    if which not in WHICH:
        raise ValueError(f"profile_posed: {which!r} is not one of {WHICH}")
    if weights not in (None, "random") and not os.path.exists(weights):
        raise FileNotFoundError(f"--weights {weights!r} does not exist")
    path = DEFAULT_WEIGHTS if weights is None else weights
    load = weights != "random" and os.path.exists(path)
    label = (os.path.basename(path) + (" (canonical/ subtree)" if which == "canonical" else "")
             if load else "random-init")
    dev = _device.resolve(device)
    torch.manual_seed(0)
    assets = GarmentAssets.synthetic(num_rings=rings, ring_size=ring_size)
    body = synthetic_smpl(num_verts=body_verts, device=dev)

    if which == "canonical":
        model = CanonicalGarmentModel(assets).to(dev).eval()
        if load:
            # the posed file's frozen canonical stage, `{coll}/canonical/...`
            model.load_state_dict(load_npz_subtree(path, "canonical"), strict=True)
        pcd = make_batch(assets, body, batch_size=batch, T=T, npoints=npoints,
                         device=dev)["pcd"]

        @torch.inference_mode()
        def step():
            return model(pcd).tpose_garment

        return step, batch * T, label

    recon = GarmentReconstructor.from_assets(assets, body, device=dev, lbs_k=lbs_k)
    if load:
        from garment4d_tpu_torch.train.convert import load_npz

        recon.model.load_state_dict(load_npz(path), strict=True)
    if which == "posed":
        data = make_batch(assets, body, batch_size=batch, T=T, npoints=npoints, device=dev)
        pcd, body_in = data["pcd"], body_inputs_from_batch(data)
        return (lambda: recon.posed(pcd, body_in)), batch * T, label

    data = make_batch(assets, body, batch_size=train_batch, T=T, npoints=npoints, seed=1,
                      device=dev)
    state = make_state_for(recon.model, lr=TRAIN_LR, freeze_canonical=True)
    train_step, _ = make_posed_steps(recon.model, assets, body.faces)
    return (lambda: train_step(state, data)["total_loss"]), train_batch * T, label


def run(which: str, iters: int, top: int, step, frames: int, device) -> dict:
    """Time `step` (median of `iters` synchronised calls after one) and
    profile `iters` calls; print both. -> the numbers printed."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    step()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        step()
        sync()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"step time: {dt * 1e3:.1f} ms  ({frames / dt:.1f} frames/s)", flush=True)
    rows, total_ms = profile_device(step, runs=iters, device=device)
    idle = print_profile(which, rows, total_ms, dt * 1e3, top=top, cpu=not cuda)
    return dict(step_ms=dt * 1e3, frames_per_sec=frames / dt, total_ms=total_ms,
                idle_share=idle, launches=sum(r[1] for r in rows), rows=rows)


def main(argv=None, **sizes) -> dict:
    """The command line; `sizes` go to `build` (a test's shrunken shapes)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="posed", choices=WHICH)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--weights", default=None,
                    help="npz variables to load (default: ckpt_synth/posed_synth.npz "
                         "where present; 'random' keeps the seeded init). Hit densities "
                         "depend on the weights, so profiles at random weights mis-rank "
                         "the query kernels.")
    ap.add_argument("--device", default=_device.DEFAULT,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    step, frames, label = build(args.which, args.batch, args.weights, args.device, **sizes)
    print(f"weights: {label}", flush=True)
    return run(args.which, args.iters, args.top, step, frames, args.device)


if __name__ == "__main__":
    main()
