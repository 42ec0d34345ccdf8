"""Host file readers of the CLOTH3D path, in numpy.

Counterpart of `garment4d_tpu/data/native.py`, whose entry points call the
C++ extension `native/g4d_native.cpp` when it builds and these numpy forms
otherwise. That extension is a host file reader, not a TPU kernel; the
port has no counterpart of it yet (ROADMAP Queue 1, the native reader),
so it reads with numpy. The results are the extension's, bit for bit:
`.bin` payloads are raw float32, OBJ vertices are written with six
decimals (a double parse rounded to float32 equals strtof there), and
`barycentric` sums in float64 in the extension's order before rounding
to float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from garment4d_tpu_torch.data.obj_io import read_obj


def read_bin(path: str) -> np.ndarray:
    """Read a .bin float32 vertex file -> (N, 3). Reference
    `dataloader.py:176` (np.fromfile)."""
    return np.fromfile(path, np.float32).reshape(-1, 3)


def read_bin_batch(paths: List[str]) -> List[np.ndarray]:
    """Read each .bin file of `paths` (the per-frame garment files)."""
    return [read_bin(p) for p in paths]


def parse_obj(path: str) -> Tuple[np.ndarray, list]:
    """Parse an OBJ: (verts (V,3) f32, faces list-of-lists)."""
    verts, faces, _, _ = read_obj(path)
    return verts, faces


def barycentric(verts: np.ndarray, ind: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Barycentric remesh (reference `mesh_utils.py:136-139`): out[i] =
    sum_k w[i, k] * verts[ind[i, k]], summed over k = 0, 1, 2 in float64,
    then rounded to float32."""
    v = np.asarray(verts, np.float32)
    ind = np.asarray(ind, np.int64)
    if ind.size and (ind.min() < 0 or ind.max() >= v.shape[0]):
        raise IndexError("barycentric index out of range")
    w = np.asarray(w, np.float64)
    acc = w[:, 0, None] * v[ind[:, 0]].astype(np.float64)
    acc = acc + w[:, 1, None] * v[ind[:, 1]].astype(np.float64)
    acc = acc + w[:, 2, None] * v[ind[:, 2]].astype(np.float64)
    return acc.astype(np.float32)
