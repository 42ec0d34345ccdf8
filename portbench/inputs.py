"""The benchmark's inputs, made from the seed: the garment template, the
body model and the batches.

A frozen copy of the port's generators (`GarmentAssets.synthetic`,
`smpl.synthetic_smpl`, `data.synthetic.make_batch` and the SMPL skinning
they run), so that a later change to the program cannot change what the
benchmark feeds it. The template and the body are fixed (seed 0, as the
JAX package's bench built them); the batches are drawn from the run's
seed. Everything here is raw data: the program derives its own operators
from the template, and the reference derives them again.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SMPL_PARENTS = np.array([0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
                         18, 19, 20, 21], np.int64)
NUM_BETAS = 10


def ring_template(num_rings: int, ring_size: int, pca_dim: int, seed: int = 0) -> dict:
    """A cylinder of `num_rings` rings of `ring_size` vertices joined by
    quads, with a random unit-row PCA basis scaled by 1/10, the template as
    its mean and unit scale (`GarmentAssets.synthetic`'s draws)."""
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
    return dict(verts=verts, faces=np.asarray(faces, np.int64), pca_components=comp,
                pca_mean=verts.reshape(-1).astype(np.float32),
                pca_explained=np.linspace(1.0, 0.01, pca_dim).astype(np.float32),
                pca_scale=np.ones((V * 3,), np.float32))


def synthetic_body(num_verts: int, seed: int = 0, num_joints: int = 24) -> dict:
    """A random SMPL-shaped body: a blob of vertices, the SMPL parent tree,
    softmax-local skinning weights, small blend shapes and a triangle soup
    (`smpl.synthetic_smpl`'s draws). numpy arrays."""
    rng = np.random.RandomState(seed)
    v_template = rng.randn(num_verts, 3).astype(np.float32) * 0.3
    v_template[:, 1] = np.linspace(-1.0, 0.6, num_verts) + rng.randn(num_verts) * 0.05
    joint_pos = rng.randn(num_joints, 3).astype(np.float32) * 0.4
    d2 = np.sum((joint_pos[:, None, :] - v_template[None, :, :]) ** 2, axis=-1)
    J_regressor = np.exp(-d2 / 0.1)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    w = np.exp(-d2.T / 0.05)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    shapedirs = (rng.randn(num_verts, 3, NUM_BETAS) * 0.01).astype(np.float32)
    posedirs = (rng.randn((num_joints - 1) * 9, num_verts * 3) * 0.001).astype(np.float32)
    faces = rng.randint(0, num_verts, size=(2 * num_verts, 3)).astype(np.int32)
    bad = ((faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2])
           | (faces[:, 0] == faces[:, 2]))
    return dict(v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
                J_regressor=J_regressor.astype(np.float32), lbs_weights=lbs_weights,
                parents=SMPL_PARENTS.copy(), faces=faces[~bad])


def body_on(body: dict, device) -> dict:
    """The body's float arrays as float32 tensors on `device`; parents and
    faces stay numpy."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
                if k not in ("parents", "faces") else v) for k, v in body.items()}


# --- SMPL skinning, float32 (smplx `lbs.py`) ---------------------------------

def rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), +1e-8 inside
    the norm."""
    shape = rot_vecs.shape[:-1]
    rv = rot_vecs.reshape(-1, 3)
    angle = torch.linalg.norm(rv + 1e-8, dim=1, keepdim=True)
    d = rv / angle
    cos, sin = torch.cos(angle)[:, :, None], torch.sin(angle)[:, :, None]
    z = torch.zeros_like(d[:, 0])
    K = torch.stack([z, -d[:, 2], d[:, 1], d[:, 2], z, -d[:, 0], -d[:, 1], d[:, 0], z],
                    dim=1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device)
    return (eye + sin * K + (1.0 - cos) * torch.bmm(K, K)).reshape(*shape, 3, 3)


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Forward kinematics -> (posed joints (B, J, 3), transforms relative
    to the rest joints (B, J, 4, 4))."""
    B, J = joints.shape[:2]
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]
    top = torch.cat([rot_mats, rel[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=joints.dtype,
                          device=joints.device).expand(B, J, 1, 4)
    local = torch.cat([top, bottom], dim=-2)
    chain = [local[:, 0]]
    for i in range(1, J):
        chain.append(torch.bmm(chain[int(parents[i])], local[:, i]))
    tf = torch.stack(chain, dim=1)
    corr = torch.zeros_like(tf)
    corr[:, :, :, 3] = torch.einsum("bjik,bjk->bji", tf[:, :, :, :3], joints)
    return tf[:, :, :3, 3], tf - corr


def smpl_forward(body: dict, betas: torch.Tensor, pose: torch.Tensor):
    """betas (B, 10), pose (B, 72) axis-angle -> (vertices (B, V, 3),
    joints (B, J, 3))."""
    B = pose.shape[0]
    v_shaped = body["v_template"][None] + torch.einsum("bl,mkl->bmk", betas,
                                                       body["shapedirs"])
    J = torch.einsum("bvc,jv->bjc", v_shaped, body["J_regressor"])
    rot = rodrigues(pose.reshape(B, -1, 3))
    eye = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    v_posed = v_shaped + ((rot[:, 1:] - eye).reshape(B, -1) @ body["posedirs"]).reshape(B, -1, 3)
    J_posed, A = rigid_transform(rot, J, body["parents"])
    W = body["lbs_weights"][None].expand(B, *body["lbs_weights"].shape)
    T = torch.einsum("bvj,bjpq->bvpq", W, A)
    verts = torch.einsum("bvpq,bvq->bvp", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]
    return verts, J_posed


def template_pose(batch: int, device) -> torch.Tensor:
    """The dataset's fixed template pose: root x-rot +pi/2, hips z +/-0.15."""
    pose = torch.zeros((batch, 24, 3), device=device)
    pose[:, 0, 0] = np.pi / 2
    pose[:, 1, 2] = 0.15
    pose[:, 2, 2] = -0.15
    return pose.reshape(batch, 72)


POOL, SAMPLE, DROPOUT = 0, 1, 2   # the streams drawn from a run's seed


def derive(seed: int, *keys: int) -> int:
    """A 32-bit seed for one use (`POOL` and the batch's index, `SAMPLE`,
    `DROPOUT`) of a run's seed, which may be any integer."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), *keys]).generate_state(1)[0])


@torch.no_grad()
def make_batch(template: dict, label: int, body: dict, *, batch_size: int, T: int,
               npoints: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A synthetic batch with the data pipeline's keys on `device` (`body`
    from `body_on` on that device): per-sequence shapes and per-frame poses,
    the three SMPL forwards (posed, T-pose, zero pose), a noisy garment
    around the template, and a point cloud of half body vertices and half
    garment points, shuffled, labelled 0 and `label`."""
    rng = np.random.RandomState(seed)
    B = batch_size
    tv = template["verts"]
    Vg, Vb = tv.shape[0], body["v_template"].shape[0]

    def dev(a):
        return torch.from_numpy(np.array(a, dtype=a.dtype)).to(device)

    pose = dev(rng.randn(B, T, 72).astype(np.float32) * 0.1)
    betas = dev(np.broadcast_to(rng.randn(B, 1, 10).astype(np.float32) * 0.5, (B, T, 10)))
    flat_pose, flat_betas = pose.reshape(B * T, 72), betas.reshape(B * T, -1)
    posed_v, posed_j = smpl_forward(body, flat_betas, flat_pose)
    tpose_v, tpose_j = smpl_forward(body, betas[:, 0], template_pose(B, device))
    zero_v, _ = smpl_forward(body, flat_betas, torch.zeros_like(flat_pose))
    body_v = posed_v.reshape(B, T, Vb, 3).cpu().numpy()
    root = posed_j[:, 0, :].reshape(B, T, 3).cpu().numpy()

    garment = tv[None, None] + rng.randn(B, T, Vg, 3).astype(np.float32) * 0.01
    n_body, n_gar = npoints - npoints // 2, npoints // 2
    pcd = np.zeros((B, T, npoints, 3), np.float32)
    labels = np.zeros((B, T, npoints), np.int32)
    for b in range(B):
        for t in range(T):
            bsel = rng.randint(0, Vb, size=n_body)
            gsel = rng.randint(0, Vg, size=n_gar)
            pts = np.concatenate([body_v[b, t, bsel], garment[b, t, gsel] + root[b, t]], 0)
            lab = np.concatenate([np.zeros(n_body, np.int32), np.full(n_gar, label, np.int32)])
            perm = rng.permutation(npoints)
            pcd[b, t] = pts[perm]
            labels[b, t] = lab[perm]

    J = body["J_regressor"].shape[0]
    return dict(
        pose=pose, beta=betas, pcd=dev(pcd), pcd_label=dev(labels), garment=dev(garment),
        garment_template_vertices=dev(np.broadcast_to(tv[None], (B, Vg, 3))),
        pca_coeff=dev(rng.randn(B, template["pca_components"].shape[0]).astype(np.float32)),
        J_regressor=body["J_regressor"][None, None].expand(B, T, J, Vb),
        lbs_weights=body["lbs_weights"][None, None].expand(B, T, Vb, J),
        smpl_vertices=posed_v.reshape(B, T, Vb, 3),
        smpl_root_joints=posed_j[:, 0, :].reshape(B, T, 3),
        tpose_smpl_vertices=tpose_v, tpose_smpl_root_joints=tpose_j[:, 0, :],
        zeropose_smpl_vertices=zero_v.reshape(B, T, Vb, 3))
