"""Wavefront OBJ reading/writing (quads preserved).

Counterpart of `garment4d_tpu/data/obj_io.py` (reference
`utils/mesh_utils.py:8-35` readOBJ, `utils/nr_utils.py:10-31` writeOBJ).
Pure python and numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def read_obj(path: str):
    """Returns (vertices (V,3) f32, faces list-of-lists, uvs or None,
    face_uvs or None)."""
    verts: List[List[float]] = []
    uvs: List[List[float]] = []
    faces: List[List[int]] = []
    face_uvs: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                tidx = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    idx.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        tidx.append(int(parts[1]) - 1)
                faces.append(idx)
                if tidx:
                    face_uvs.append(tidx)
    v = np.asarray(verts, np.float32)
    t = np.asarray(uvs, np.float32) if uvs else None
    ft = face_uvs if face_uvs else None
    return v, faces, t, ft


def write_obj(path: str, vertices: np.ndarray, faces=None) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vertices).reshape(-1, 3):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for face in faces:
                f.write("f " + " ".join(str(int(i) + 1) for i in face) + "\n")


def interpolate_barycentric(v: np.ndarray, ind: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Barycentric remesh: v (N,3) source verts, ind (M,3) triangle vertex ids,
    w (M,3) weights -> (M,3). Reference `utils/mesh_utils.py:136-139`."""
    indv = v[ind]  # (M, 3, 3)
    return np.einsum("mk,mkc->mc", w, indv)
