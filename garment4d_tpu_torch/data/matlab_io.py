"""Matlab .mat structure loading (reference `utils/mesh_utils.py:37-78`).

Counterpart of `garment4d_tpu/data/matlab_io.py` (scipy only, no device).

CLOTH3D's original release stores per-sequence info as matlab structs; the
reference's `loadInfo` recursively converts mat_struct objects to dicts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def load_info(filename: str) -> Dict[str, Any]:
    """Load a .mat file into nested plain dicts (squeezed)."""
    import scipy.io

    data = scipy.io.loadmat(filename, struct_as_record=False, squeeze_me=True)
    return _check_keys({k: v for k, v in data.items()
                        if not k.startswith("__")})


def _check_keys(d: Dict[str, Any]) -> Dict[str, Any]:
    import scipy.io.matlab as ml

    for key, value in d.items():
        if isinstance(value, ml.mat_struct):
            d[key] = _todict(value)
    return d


def _todict(matobj) -> Dict[str, Any]:
    import scipy.io.matlab as ml

    out: Dict[str, Any] = {}
    for name in matobj._fieldnames:
        elem = getattr(matobj, name)
        if isinstance(elem, ml.mat_struct):
            out[name] = _todict(elem)
        else:
            out[name] = elem
    return out
