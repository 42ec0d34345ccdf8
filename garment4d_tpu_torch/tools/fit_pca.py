"""PCA-basis fitting for garment templates.

Counterpart of `garment4d_tpu/tools/fit_pca.py` (numpy only, no device).
The reference consumes a precomputed `PCABase_SS.pkl`
{components, mean, explained, ss_scale} per garment class
(`modules/mesh_encoder.py:89-94`) without shipping the code that builds it.
This tool reproduces the format from a set of registered canonical garment
meshes: StandardScaler (per-coordinate std) + PCA via SVD, so users can
regenerate the basis for new garments/templates.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np


def fit_pca_basis(vertices: np.ndarray, n_components: int = 64,
                  eps: float = 1e-8) -> Dict[str, np.ndarray]:
    """vertices: (S, V, 3) registered garments (same topology) ->
    dict with the PCABase_SS.pkl keys.

    Scaling convention matches the reference's inverse transform
    (`mesh_encoder.py:101-107`): verts = (coeff @ components + mean) * ss_scale,
    i.e. PCA is fit on x / ss_scale with ss_scale the per-dim std.
    """
    S, V, _ = vertices.shape
    flat = vertices.reshape(S, V * 3).astype(np.float64)
    ss_scale = flat.std(axis=0)
    ss_scale = np.where(ss_scale < eps, 1.0, ss_scale)
    scaled = flat / ss_scale
    mean = scaled.mean(axis=0)
    centered = scaled - mean
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    k = min(n_components, vt.shape[0])
    components = vt[:k]
    explained = (s[:k] ** 2) / max(S - 1, 1)
    return {
        "components": components.astype(np.float32),
        "mean": mean.astype(np.float32),
        "explained": explained.astype(np.float32),
        "ss_scale": ss_scale.astype(np.float32),
    }


def transform(basis: Dict[str, np.ndarray], vertices: np.ndarray) -> np.ndarray:
    """(S, V, 3) -> (S, k) coefficients (the PCACoeff_SS.pkl content)."""
    flat = vertices.reshape(vertices.shape[0], -1) / basis["ss_scale"]
    return ((flat - basis["mean"]) @ basis["components"].T).astype(np.float32)


def inverse_transform(basis: Dict[str, np.ndarray], coeff: np.ndarray) -> np.ndarray:
    """(S, k) -> (S, V, 3); mirrors the model's PCA_inverse_transform."""
    flat = (coeff @ basis["components"] + basis["mean"]) * basis["ss_scale"]
    return flat.reshape(coeff.shape[0], -1, 3)


def save_basis(path: str, basis: Dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        pickle.dump(basis, f)
