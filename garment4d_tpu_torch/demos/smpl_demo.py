"""SMPL body-model demo: sample a shape, run the forward, export the mesh.

Counterpart of `demos/smpl_demo.py` (the reference's vendored
`smplx/examples/demo.py:26-80` and its `vis_*_vertices.py` scripts): build a
body model (synthetic, 890 vertices, or a released file), sample betas and
a pose from `RandomState(seed)` as the JAX demo does, run the forward on
the card (`--cpu` for the CPU), print the vertex and joint shapes, and
write what the reference's viewers would show: an OBJ of the body, a PLY
of the joints (`--plot-joints`) and a software-rasterised preview.

Usage: python -m garment4d_tpu_torch.demos.smpl_demo [--model-file SMPL_N.pkl]
           [--pose zero|random] [--plot-joints] [--out demo_out/smpl] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from garment4d_tpu_torch import _device, smpl
from garment4d_tpu_torch.data.export import render_mesh, save_image, write_ply_pointcloud
from garment4d_tpu_torch.data.obj_io import write_obj
from garment4d_tpu_torch.smpl.model import NUM_BETAS, NUM_JOINTS


def sample_inputs(seed: int = 0, num_betas: int = 10, sample_shape: bool = True,
                  pose: str = "zero"):
    """The JAX demo's inputs: betas (1, 10) with the first `num_betas` drawn
    N(0, 1) when `sample_shape`, and an axis-angle pose (1, 72), zero or
    N(0, 0.2^2). -> (betas, pose), float32 numpy."""
    rng = np.random.RandomState(seed)
    betas = np.zeros((1, NUM_BETAS), np.float32)
    if sample_shape:
        betas[:, :num_betas] = rng.randn(1, num_betas)
    theta = np.zeros((1, NUM_JOINTS * 3), np.float32)
    if pose == "random":
        theta = (rng.randn(1, NUM_JOINTS * 3) * 0.2).astype(np.float32)
    return betas, theta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-file", default=None,
                    help="released SMPL .pkl/.npz; synthetic when omitted")
    ap.add_argument("--num-betas", type=int, default=10)
    ap.add_argument("--sample-shape", action="store_true", default=True)
    ap.add_argument("--no-sample-shape", dest="sample_shape", action="store_false")
    ap.add_argument("--plot-joints", action="store_true", default=False)
    ap.add_argument("--pose", choices=["zero", "random"], default="zero")
    ap.add_argument("--out", default="demo_out/smpl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    dev = _device.resolve("cpu" if args.cpu else _device.DEFAULT)
    if args.model_file:
        model = smpl.load_smpl(args.model_file, device=dev)
    else:
        model = smpl.synthetic_smpl(num_verts=890, seed=args.seed, device=dev)
    print(f"SMPL model: {model.num_verts} vertices, {model.parents.shape[0]} joints, "
          f"{'loaded ' + args.model_file if args.model_file else 'synthetic'}")

    betas, pose = sample_inputs(args.seed, args.num_betas, args.sample_shape, args.pose)
    with torch.inference_mode():
        vertices, joints = model.forward_axis_angle(torch.as_tensor(betas, device=dev),
                                                    torch.as_tensor(pose, device=dev))
    vertices = vertices[0].cpu().numpy()
    joints = joints[0].cpu().numpy()
    print("Vertices shape =", vertices.shape)
    print("Joints shape =", joints.shape)

    os.makedirs(args.out, exist_ok=True)
    write_obj(os.path.join(args.out, "body.obj"), vertices, model.faces)
    save_image(os.path.join(args.out, "body_preview.png"), render_mesh(vertices, model.faces))
    if args.plot_joints:
        write_ply_pointcloud(os.path.join(args.out, "joints.ply"), joints)
    print(f"wrote {args.out}/body.obj, body_preview.png"
          + (", joints.ply" if args.plot_joints else ""))
    print("OK")
    return vertices, joints


if __name__ == "__main__":
    main()
