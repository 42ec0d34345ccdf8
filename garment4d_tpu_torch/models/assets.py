"""Garment template assets: mesh, PCA basis, graph operators (numpy).

Counterpart of `garment4d_tpu/models/assets.py`. `synthetic` draws the same
`RandomState` numbers in the same order, so it gives bit-identical arrays;
`from_files` loads the reference's template OBJ and PCA pickle, and
`permuted` re-indexes the vertices.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Sequence

import numpy as np

from garment4d_tpu_torch.data.obj_io import read_obj
from garment4d_tpu_torch.ops.graph import (
    build_mesh_adjacency,
    gcn_adjacency,
    laplacian_adjacency,
    smoothing_operator,
)

# Point-cloud semantic classes (reference `utils/dataloader.py:15-24`).
LABEL_DICT = {
    "Body": 1,
    "Skirt": 2,
    "Dress": 3,
    "Jumpsuit": 4,
    "Top": 5,
    "Trousers": 6,
    "Tshirt": 7,
}
CLASS_NUM = 7


def quads_to_tris(faces: Sequence[Sequence[int]]) -> np.ndarray:
    """Split quad faces into triangles."""
    out = []
    for f in faces:
        f = list(f)
        if len(f) == 3:
            out.append(f)
        elif len(f) == 4:
            out.append([f[0], f[1], f[2]])
            out.append([f[0], f[2], f[3]])
        else:
            raise ValueError(f"face of degree {len(f)}")
    return np.asarray(out, np.int32)


@dataclasses.dataclass(frozen=True)
class GarmentAssets:
    """Static per-garment data: template mesh, PCA basis, graph operators."""

    name: str
    template_v: np.ndarray       # (V, 3) canonical template vertices
    faces: tuple                 # original faces (tris and/or quads)
    faces_tri: np.ndarray        # (F, 3) triangulated
    pca_components: np.ndarray   # (pca_dim, V*3)
    pca_mean: np.ndarray         # (V*3,)
    pca_explained: np.ndarray    # (pca_dim,)
    pca_scale: np.ndarray        # scalar or (V*3,) standard-scaler scale
    gcn_adj: np.ndarray          # (V, V) row-normalised (A + I)
    lap_adj: np.ndarray          # (V, V) I - norm(A)
    smooth_op: np.ndarray        # (V, V) 100-step weight diffusion operator

    @property
    def label(self) -> int:
        """0-based semantic label of this garment."""
        return LABEL_DICT[self.name] - 1

    @property
    def num_verts(self) -> int:
        return self.template_v.shape[0]

    @property
    def pca_dim(self) -> int:
        return self.pca_components.shape[0]

    @staticmethod
    def build(name: str, template_v: np.ndarray, faces: Sequence[Sequence[int]],
              pca_components: np.ndarray, pca_mean: np.ndarray,
              pca_explained: np.ndarray, pca_scale: np.ndarray) -> "GarmentAssets":
        v = np.asarray(template_v, np.float32)
        adj = build_mesh_adjacency(faces, v.shape[0])
        return GarmentAssets(
            name=name,
            template_v=v,
            faces=tuple(tuple(int(i) for i in f) for f in faces),
            faces_tri=quads_to_tris(faces),
            pca_components=np.asarray(pca_components, np.float32),
            pca_mean=np.asarray(pca_mean, np.float32),
            pca_explained=np.asarray(pca_explained, np.float32),
            pca_scale=np.asarray(pca_scale, np.float32),
            gcn_adj=gcn_adjacency(adj),
            lap_adj=laplacian_adjacency(adj),
            smooth_op=smoothing_operator(adj),
        )

    @classmethod
    def from_files(cls, name: str, template_obj: str, pca_pickle: str,
                   pca_dim: int = 64) -> "GarmentAssets":
        """Load from the reference's on-disk format: template OBJ (quads kept)
        + PCABase_SS.pkl {components, mean, explained, ss_scale}
        (reference `mesh_encoder.py:89-99`)."""
        verts, faces, _, _ = read_obj(template_obj)
        with open(pca_pickle, "rb") as f:
            pca = pickle.load(f)
        return cls.build(
            name=name,
            template_v=verts,
            faces=faces,
            pca_components=pca["components"][:pca_dim],
            pca_mean=pca["mean"],
            pca_explained=pca["explained"][:pca_dim],
            pca_scale=pca["ss_scale"].astype(np.float32),
        )

    def permuted(self, perm: np.ndarray) -> "GarmentAssets":
        """The same garment with vertices re-indexed: new vertex i is old
        vertex perm[i]. Faces, the per-vertex blocks of the PCA basis /
        mean / scale, AND the graph operators are remapped consistently, so
        the permuted assets describe the IDENTICAL mesh and compute the
        identical GCN/smoothing math - used by tests to model real
        templates whose OBJ vertex order is not grid-coherent.

        The graph operators are relabelled directly (op[perm][:, perm])
        rather than rebuilt from the permuted faces: `build_mesh_adjacency`
        reproduces the reference's tri-face quirk of inserting a spurious
        (0, 0) entry at the LITERAL index 0, which would re-anchor at the
        new vertex 0 on a rebuild instead of following the permutation -
        the relabelled matrix keeps it at (inv[0], inv[0]), i.e. the same
        mesh vertex (this matches the production band-reorder path in
        models/posed.py, which also relabels the built matrix)."""
        perm = np.asarray(perm, np.int64)
        V = self.num_verts
        inv = np.argsort(perm)
        comp = self.pca_components.reshape(-1, V, 3)[:, perm].reshape(
            self.pca_components.shape[0], -1)
        mean = self.pca_mean.reshape(V, 3)[perm].reshape(-1)
        scale = self.pca_scale
        if scale.ndim and scale.size == V * 3:
            scale = scale.reshape(V, 3)[perm].reshape(-1)
        faces = [[int(inv[i]) for i in f] for f in self.faces]
        built = GarmentAssets.build(
            name=self.name,
            template_v=self.template_v[perm],
            faces=faces,
            pca_components=comp,
            pca_mean=mean,
            pca_explained=self.pca_explained,
            pca_scale=scale,
        )
        return dataclasses.replace(
            built,
            gcn_adj=np.ascontiguousarray(self.gcn_adj[perm][:, perm]),
            lap_adj=np.ascontiguousarray(self.lap_adj[perm][:, perm]),
            smooth_op=np.ascontiguousarray(self.smooth_op[perm][:, perm]),
        )

    @classmethod
    def synthetic(cls, name: str = "Skirt", num_rings: int = 12,
                  ring_size: int = 16, pca_dim: int = 64,
                  seed: int = 0) -> "GarmentAssets":
        """A cylinder-mesh garment (quad faces, like CLOTH3D skirt
        templates) with a random orthonormal-ish PCA basis."""
        rng = np.random.RandomState(seed)
        V = num_rings * ring_size
        theta = np.linspace(0, 2 * np.pi, ring_size, endpoint=False)
        verts = []
        for r in range(num_rings):
            y = -0.3 - 0.5 * r / max(num_rings - 1, 1)
            rad = 0.2 + 0.1 * r / max(num_rings - 1, 1)
            for t in theta:
                verts.append([rad * np.cos(t), y, rad * np.sin(t)])
        verts = np.asarray(verts, np.float32)
        faces = []
        for r in range(num_rings - 1):
            for c in range(ring_size):
                a = r * ring_size + c
                b = r * ring_size + (c + 1) % ring_size
                faces.append([a, b, b + ring_size, a + ring_size])
        comp = rng.randn(pca_dim, V * 3).astype(np.float32)
        comp /= np.linalg.norm(comp, axis=1, keepdims=True) * 10.0
        return cls.build(
            name=name,
            template_v=verts,
            faces=faces,
            pca_components=comp,
            pca_mean=verts.reshape(-1).astype(np.float32),
            pca_explained=np.linspace(1.0, 0.01, pca_dim).astype(np.float32),
            pca_scale=np.ones((V * 3,), np.float32),
        )
