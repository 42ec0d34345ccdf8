"""SMPL body model: a tensor container with an axis-angle forward.

Counterpart of `garment4d_tpu/smpl/model.py`. `synthetic_smpl` draws the
same `RandomState` numbers as the JAX package, so both build the same body.
`load_smpl` reads a released SMPL_{GENDER}.pkl (without chumpy) or an npz
with the same buffers. `forward_rotmats` takes the pose as rotation
matrices (the reference's `SMPLLayer` with `pose2rot=False`).
"""

from __future__ import annotations

import dataclasses
import io
import pickle

import numpy as np
import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.smpl.lbs import lbs as _lbs

NUM_JOINTS = 24
NUM_BETAS = 10
NUM_BODY_VERTS = 6890


@dataclasses.dataclass(frozen=True)
class SmplModel:
    """SMPL buffers: v_template (V, 3), shapedirs (V, 3, 10), posedirs
    (P, V*3) with P = (J-1)*9, J_regressor (J, V), lbs_weights (V, J);
    parents (J,) and faces (F, 3) stay numpy."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    J_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    parents: np.ndarray
    faces: np.ndarray

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    def forward_rotmats(self, betas: torch.Tensor, rot_mats: torch.Tensor):
        """betas (B, 10), rot_mats (B, J, 3, 3) -> (vertices, joints)."""
        return _lbs(betas, rot_mats, self.v_template, self.shapedirs,
                    self.posedirs, self.J_regressor, self.parents,
                    self.lbs_weights, pose2rot=False)

    def forward_axis_angle(self, betas: torch.Tensor, pose: torch.Tensor):
        """betas (B, 10), pose (B, J*3) axis-angle -> (vertices, joints)."""
        return _lbs(betas, pose, self.v_template, self.shapedirs,
                    self.posedirs, self.J_regressor, self.parents,
                    self.lbs_weights)


class _ChumpyUnpickler(pickle.Unpickler):
    """Unpickle SMPL .pkl files without chumpy installed.

    The released SMPL pickles store chumpy `Ch` arrays; the class maps to a
    shim whose __setstate__ keeps only the ndarray payload.
    """

    class _ChShim:
        def __setstate__(self, state):
            self.__dict__.update(state)

        def __array__(self, dtype=None):
            for key in ("x", "a", "_data"):
                if key in self.__dict__:
                    return np.asarray(self.__dict__[key], dtype=dtype)
            raise ValueError("unrecognised chumpy payload")

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyUnpickler._ChShim
        if module == "scipy.sparse.csc" and name == "csc_matrix":
            import scipy.sparse

            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray(), dtype=np.float64)
    return np.asarray(x)


def _on_device(device, v_template, shapedirs, posedirs, J_regressor,
               lbs_weights, parents, faces) -> SmplModel:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return SmplModel(v_template=t(v_template), shapedirs=t(shapedirs),
                     posedirs=t(posedirs), J_regressor=t(J_regressor),
                     lbs_weights=t(lbs_weights),
                     parents=np.asarray(parents, np.int64),
                     faces=np.asarray(faces, np.int32))


def load_smpl_pickle(path: str, device=_device.DEFAULT) -> SmplModel:
    """Load a released SMPL_{GENDER}.pkl (latin1 pickle, chumpy buffers) onto
    `device`: posedirs (V, 3, P) -> (P, V*3), kintree_table[0] -> parents
    with the root's -1 set to 0 (never indexed), shapedirs cut to 10 betas
    (reference `body_models.py:214-250`)."""
    device = _device.resolve(device)
    with open(path, "rb") as f:
        data = _ChumpyUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    posedirs_raw = _to_np(data["posedirs"]).astype(np.float32)
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = 0
    return _on_device(
        device,
        v_template=_to_np(data["v_template"]).astype(np.float32),
        shapedirs=_to_np(data["shapedirs"]).astype(np.float32)[:, :, :NUM_BETAS],
        posedirs=posedirs_raw.reshape(-1, posedirs_raw.shape[-1]).T,
        J_regressor=_to_np(data["J_regressor"]).astype(np.float32),
        lbs_weights=_to_np(data["weights"]).astype(np.float32),
        parents=parents,
        faces=_to_np(data["f"]).astype(np.int32))


def load_smpl_npz(path: str, device=_device.DEFAULT) -> SmplModel:
    """Load from an .npz with the same keys as the model's fields (test
    fixtures, converted models) onto `device`."""
    device = _device.resolve(device)
    with np.load(path) as data:
        return _on_device(device, **{k: data[k] for k in (
            "v_template", "shapedirs", "posedirs", "J_regressor",
            "lbs_weights", "parents", "faces")})


def load_smpl(path: str, device=_device.DEFAULT) -> SmplModel:
    """`load_smpl_npz` for an .npz path, else `load_smpl_pickle`."""
    if path.endswith(".npz"):
        return load_smpl_npz(path, device)
    return load_smpl_pickle(path, device)


def synthetic_smpl(num_verts: int = 400, seed: int = 0,
                   num_joints: int = NUM_JOINTS,
                   device=_device.DEFAULT) -> SmplModel:
    """A small random-but-valid SMPL-shaped body model: vertices on a
    capsule-ish blob, the real SMPL parent tree (if num_joints == 24),
    softmax-local skinning weights, small random blendshapes. On the card
    unless `device` says otherwise."""
    device = _device.resolve(device)
    rng = np.random.RandomState(seed)
    smpl_parents = np.array(
        [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
         18, 19, 20, 21], np.int64)
    if num_joints == NUM_JOINTS:
        parents = smpl_parents
    else:
        parents = np.concatenate([[0], np.arange(num_joints - 1)]).astype(np.int64)

    v_template = rng.randn(num_verts, 3).astype(np.float32) * 0.3
    v_template[:, 1] = np.linspace(-1.0, 0.6, num_verts) + rng.randn(num_verts) * 0.05
    joint_pos = rng.randn(num_joints, 3).astype(np.float32) * 0.4

    d2 = np.sum((joint_pos[:, None, :] - v_template[None, :, :]) ** 2, axis=-1)
    J_regressor = np.exp(-d2 / 0.1)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    J_regressor = J_regressor.astype(np.float32)

    w = np.exp(-d2.T / 0.05)  # (V, J)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    shapedirs = (rng.randn(num_verts, 3, NUM_BETAS) * 0.01).astype(np.float32)
    posedirs = (rng.randn((num_joints - 1) * 9, num_verts * 3) * 0.001).astype(np.float32)

    faces = rng.randint(0, num_verts, size=(2 * num_verts, 3)).astype(np.int32)
    bad = (faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2]) | (faces[:, 0] == faces[:, 2])
    faces = faces[~bad]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SmplModel(v_template=t(v_template), shapedirs=t(shapedirs),
                     posedirs=t(posedirs), J_regressor=t(J_regressor),
                     lbs_weights=t(lbs_weights), parents=parents, faces=faces)
