"""Mini-CLOTH3D fixture writer: a tiny dataset tree in the on-disk format
the reference reads (README.md:58-72), for end-to-end tests of the data
path without the real CLOTH3D data.

Counterpart of `garment4d_tpu/data/fixture.py`: the same draws in the same
order, so both packages write byte-identical trees from one seed and one
set of assets."""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from garment4d_tpu_torch.data.obj_io import write_obj
from garment4d_tpu_torch.models.assets import GarmentAssets


def write_fixture(root: str, assets: GarmentAssets, *, num_seqs: int = 2,
                  frames_per_seq: int = 6, garment_points: int = 700,
                  seed: int = 0) -> Dict[str, str]:
    """Writes <root>/{CLOTH3D, CLOTH3D_template, <G>_reg, list} and returns
    the file-list paths."""
    rng = np.random.RandomState(seed)
    g = assets.name
    reg = f"{g}_reg"
    os.makedirs(os.path.join(root, "list"), exist_ok=True)

    frame_names = []
    for s in range(num_seqs):
        seq = f"{10000 + s}"
        seq_dir = os.path.join(root, "CLOTH3D", seq)
        os.makedirs(seq_dir, exist_ok=True)
        with open(os.path.join(seq_dir, "gender.pkl"), "wb") as f:
            pickle.dump(int(s % 2), f)

        reg_dir = os.path.join(root, reg, seq)
        os.makedirs(reg_dir, exist_ok=True)
        with open(os.path.join(reg_dir, "PCACoeff_SS.pkl"), "wb") as f:
            pickle.dump(rng.randn(128).astype(np.float32), f)
        # remesh weights: garment template verts expressed barycentrically in
        # the raw garment mesh; identity-ish mapping onto random source tris
        Vg = assets.num_verts
        remesh = []
        for _ in range(Vg):
            ind = rng.randint(0, garment_points, size=3)
            w = rng.rand(3)
            remesh.append({"ind": ind.astype(np.int64), "w": (w / w.sum())})
        with open(os.path.join(reg_dir, "remesh_weights.pkl"), "wb") as f:
            pickle.dump(remesh, f)

        # the per-sequence template OBJ is in the *raw* garment topology; the
        # remesh weights map it onto the registered template (reference
        # `dataloader.py:248-252`)
        tmpl_dir = os.path.join(root, "CLOTH3D_template", seq)
        os.makedirs(tmpl_dir, exist_ok=True)
        raw_template = (assets.template_v[rng.randint(0, Vg, garment_points)]
                        + rng.randn(garment_points, 3).astype(np.float32) * 0.005)
        raw_faces = [[i, (i + 1) % garment_points, (i + 2) % garment_points]
                     for i in range(0, garment_points - 2, 3)]
        write_obj(os.path.join(tmpl_dir, f"{g}.obj"), raw_template, raw_faces)

        for t in range(frames_per_seq):
            frame = f"{t:05d}"
            fdir = os.path.join(seq_dir, frame)
            os.makedirs(fdir, exist_ok=True)
            with open(os.path.join(fdir, "smpl_param.pkl"), "wb") as f:
                pickle.dump({
                    "pose": rng.randn(72).astype(np.float32) * 0.1,
                    "shape": rng.randn(10).astype(np.float32) * 0.3,
                    "zrot": float(rng.rand() * 2 * np.pi),
                }, f)
            pts = (assets.template_v[rng.randint(0, Vg, garment_points)]
                   + rng.randn(garment_points, 3).astype(np.float32) * 0.01)
            pts.astype(np.float32).tofile(os.path.join(fdir, f"{g}0.bin"))
            with open(os.path.join(fdir, "garment_flist.txt"), "w") as f:
                f.write(f"{g}0.bin\n")
            frame_names.append(f"{seq}/{frame}")

    train_list = os.path.join(root, "list", "train.txt")
    eval_list = os.path.join(root, "list", "eval.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(frame_names) + "\n")
    with open(eval_list, "w") as f:
        f.write("\n".join(frame_names) + "\n")
    return {"train": train_list, "eval": eval_list}
