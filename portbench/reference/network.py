"""The plain reference of Garment4D's network in float32 torch.

Functional: the weights are a dict keyed by the Flax variable paths of
`ckpt_synth/posed_synth.npz` (`params/...`, `batch_stats/...`), read from
the file itself (`load_weights`), and every layer is written out from the
reference model (`modules/mesh_encoder.py`, `pointnet2encoder.py`,
`pygcn/layers.py`): PointNet++ segmentation, first-N garment points, the
MSG garment encoder, the PCA head, interpolated LBS with the 100-step
weight smoothing, and three refinements of body and garment query-group
PE blocks, temporal attention and a 4-layer GCN. Dense adjacency, no
kernel, no cache. It imports nothing of the program.

Training mode (`train=True`) is Flax's: BatchNorm on the batch's mean and
biased variance E[x^2] - E[x]^2, dropout kept where a uniform draw from
the caller's generator falls below 1 - p, scaled by 1 / (1 - p).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

from portbench.inputs import body_on, rigid_transform, rodrigues
from portbench.reference import geometry as G

BN_EPS = 1e-5
HIDDEN = 128
ITERATIONS = 3


def load_weights(path: str, device, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{flax path: float32 tensor on device} of every variable of the npz;
    with `prefix` ("canonical") only that subtree, the prefix dropped."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            if "/" not in k:
                continue
            coll, _, rest = k.partition("/")
            if prefix:
                head, _, rest = rest.partition("/")
                if head != prefix or not rest:
                    continue
            out[f"{coll}/{rest}"] = torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
    return out


class Net:
    """The network over one weights dict. `sizes` are the configuration's
    (`lbs_k`, `garment_nsample`, `body_nsample`, radii); `template` and
    `body` the raw arrays of `portbench.inputs`. `canonical_prefix`: where
    the canonical stage's variables sit in `W` ("canonical/" in the posed
    model's file, "" for a canonical model's)."""

    def __init__(self, W: Dict[str, torch.Tensor], template: dict, body: dict, label: int,
                 sizes: dict, device, canonical_prefix: str = "canonical/"):
        self.W, self.label, self.sizes = W, label, sizes
        self.cp = canonical_prefix
        self.device = torch.device(device)
        V = template["verts"].shape[0]
        adj = G.mesh_adjacency(template["faces"], V)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        self.gcn_adj = f32(G.row_normalize(adj + np.eye(V)))
        self.smooth_step = f32(G.row_normalize(adj) - np.eye(V))
        self.lap = f32(np.eye(V) - G.row_normalize(adj))
        self.faces_tri = torch.from_numpy(G.quads_to_tris(template["faces"])).to(self.device)
        self.body_faces = torch.from_numpy(np.asarray(body["faces"], np.int64)).to(self.device)
        self.parents = np.asarray(body["parents"], np.int64)
        self.pca = (f32(template["pca_components"]), f32(template["pca_mean"]),
                    f32(template["pca_scale"]))

    @classmethod
    def of(cls, cell, device, canonical_only: bool = False) -> "Net":
        """The reference of a benchmark cell (`harness.Cell`): its weights
        file, template, body, label and sizes; with `canonical_only` the
        canonical stage's variables alone, at the top of the tree."""
        W = load_weights(cell.weights, device, prefix="canonical" if canonical_only else "")
        return cls(W, cell.template, body_on(cell.body, device), cell.config["garment_label"],
                   cell.sizes, device, canonical_prefix="" if canonical_only else "canonical/")

    # --- dense layers ----------------------------------------------------
    def bn(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        W = self.W
        rows = x.reshape(-1, x.shape[-1])
        if train:
            mean = rows.mean(0)
            var = torch.clamp((rows * rows).mean(0) - mean * mean, min=0.0)
        else:
            mean, var = W[f"batch_stats/{name}/mean"], W[f"batch_stats/{name}/var"]
        return ((x - mean) * (torch.rsqrt(var + BN_EPS) * W[f"params/{name}/scale"])
                + W[f"params/{name}/bias"])

    def conv(self, name: str, x: torch.Tensor, bn: bool, relu: bool, train: bool):
        """A 1x1 convolution over the last axis (kernel (in, out), bias
        where the file has one), then BatchNorm and ReLU."""
        y = x @ self.W[f"params/{name}/conv/kernel"]
        b = self.W.get(f"params/{name}/conv/bias")
        if b is not None:
            y = y + b
        if bn:
            y = self.bn(f"{name}/bn", y, train)
        return torch.relu(y) if relu else y

    def mlp(self, name: str, x: torch.Tensor, layers: int, train: bool):
        for i in range(layers):
            x = self.conv(f"{name}/layer{i}", x, True, True, train)
        return x

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.W[f"params/{name}/kernel"]
        b = self.W.get(f"params/{name}/bias")
        return y if b is None else y + b

    # --- PointNet++ ------------------------------------------------------
    def set_abstraction(self, name, xyz, feats, npoint, radii, nsamples, layers, train):
        """MSG set abstraction: FPS centers, per radius the grouped
        (xyz - center, features) through its MLP, max over the samples;
        npoint None groups all points (no centering)."""
        table = xyz if feats is None else torch.cat([xyz, feats], -1)
        if npoint is None:
            h = self.mlp(f"{name}/mlp0", table[:, None], layers[0], train)
            return None, h.max(dim=2).values
        centers = G.gather_rows(xyz, G.furthest_point_sample(xyz, npoint))
        outs = []
        for i, (r, s) in enumerate(zip(radii, nsamples)):
            idx = G.ball_query(r, s, xyz, centers)
            g = G.gather_rows(table, idx)
            g = torch.cat([g[..., :3] - centers[:, :, None, :], g[..., 3:]], -1)
            outs.append(self.mlp(f"{name}/mlp{i}", g, layers[i], train).max(dim=2).values)
        return centers, torch.cat(outs, -1)

    def feature_propagation(self, name, unknown, known, unknown_feats, known_feats, train):
        d2, idx = G.nearest(unknown, known, 3)
        recip = 1.0 / (torch.sqrt(d2) + 1e-8)
        w = recip / recip.sum(-1, keepdim=True)
        g = G.gather_rows(known_feats, idx)
        x = (g * w[..., None]).sum(2)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], -1)
        return self.mlp(f"{name}/mlp", x, 2, train)

    def segment(self, pcd, train, generator):
        """pcd (F, N, 3) -> (logits (F, N, 7), level-0 features (F, N, 64))."""
        p = f"{self.cp}pointnet"
        xyz, feats = [pcd], [None]
        specs = (("sa1", 1024, (0.05, 0.1), (16, 32)), ("sa2", 256, (0.1, 0.2), (16, 32)),
                 ("sa3", 64, (0.2, 0.4), (32, 64)))
        for name, npoint, radii, ns in specs:
            c, f = self.set_abstraction(f"{p}/{name}", xyz[-1], feats[-1], npoint, radii, ns,
                                        (3, 3), train)
            xyz.append(c)
            feats.append(f)
        for i in (3, 2, 1):
            feats[i - 1] = self.feature_propagation(f"{p}/fp{i}", xyz[i - 1], xyz[i],
                                                    feats[i - 1], feats[i], train)
        h = self.conv(f"{p}/head0", feats[0], True, True, train)
        if train:
            u = torch.rand(h.shape, generator=generator, dtype=h.dtype, device=h.device)
            h = torch.where(u < 0.5, h / 0.5, torch.zeros_like(h))
        return self.conv(f"{p}/head1", h, False, False, train), feats[0]

    # --- canonical stage -------------------------------------------------
    def canonical(self, pcd: torch.Tensor, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> dict:
        """pcd (B, T, N, 3) -> sem_logits (B*T, N, 7), the garment levels,
        the PCA coefficients (B, pca) and the T-pose garment (B, V, 3)."""
        B, T, N, _ = pcd.shape
        x = pcd.reshape(B * T, N, 3)
        logits, f0 = self.segment(x, train, generator)
        # the first N // 4 points labelled as the garment, in index order, zero-padded
        n = N // 4
        labels = logits.detach().argmax(-1)
        iota = torch.arange(N, device=x.device)
        pos = torch.where(labels == self.label, iota, N)
        first = torch.sort(pos, dim=-1).values[:, :n]
        valid = (first < N)[..., None]
        safe = torch.where(first < N, first, torch.zeros_like(first))
        gx = torch.where(valid, G.gather_rows(x, safe), 0.0)
        gf = torch.where(valid, G.gather_rows(f0, safe), 0.0)
        c1, f1 = self.set_abstraction(f"{self.cp}garment_sa1", gx, gf, 512, (0.05, 0.1), (16, 32),
                                      (2, 2), train)
        c2, f2 = self.set_abstraction(f"{self.cp}garment_sa2", c1, f1, 64, (0.2, 0.4), (32, 64),
                                      (2, 2), train)
        _, summary = self.set_abstraction(f"{self.cp}garment_summarize", c2, f2, None, None, None,
                                          (2,), train)
        pooled = summary.reshape(B, T, -1).max(dim=1).values
        h = self.conv(f"{self.cp}pca_head0", pooled, True, True, train)
        h = self.conv(f"{self.cp}pca_head1", h, True, True, train)
        coeff = self.conv(f"{self.cp}pca_head2", h, False, False, train)
        comp, mean, scale = self.pca
        tpose = ((coeff @ comp + mean) * scale).reshape(B, -1, 3)
        return dict(sem_logits=logits, levels=((gx, gf), (c1, f1), (c2, f2)),
                    pca_coeff=coeff, tpose_garment=tpose)

    # --- interpolated LBS (reference `mesh_encoder.py:312-410`) ----------
    def _transfer(self, garment, tpose, w0, k):
        d2, idx = G.nearest(garment, tpose, k)
        iw = 1.0 / d2
        iw = torch.where(torch.isinf(iw), torch.zeros_like(iw), iw)
        iw = iw / iw.sum(-1, keepdim=True)
        iw = torch.where(torch.isinf(iw), torch.zeros_like(iw), iw)
        return (G.gather_rows(w0, idx) * iw[..., None]).sum(2)

    def lbs(self, tpose_garment, batch) -> torch.Tensor:
        """The canonical garment skinned to every frame: (B, T, V, 3)."""
        B, V, _ = tpose_garment.shape
        T = batch["pose"].shape[1]
        k = self.sizes["lbs_k"]
        tpose_body = batch["tpose_smpl_vertices"]
        jreg, w0 = batch["J_regressor"][:, 0], batch["lbs_weights"][:, 0]
        rooted = tpose_garment + batch["tpose_smpl_root_joints"][:, None, :]
        nn_w = self._transfer(rooted, tpose_body, w0, k)
        inv_w = self._transfer(rooted, tpose_body, w0, min(64, k))

        inv_pose = torch.zeros((B, 24, 3), device=rooted.device)
        inv_pose[:, 0, 0] = -np.pi / 2
        inv_pose[:, 1, 1] = 0.15
        inv_pose[:, 2, 1] = -0.15
        inv_J = torch.einsum("bvc,bjv->bjc", tpose_body, jreg)
        _, inv_A = rigid_transform(rodrigues(inv_pose), inv_J, self.parents)
        inv_T = torch.einsum("bvj,bjpq->bvpq", inv_w, inv_A)
        unposed = torch.einsum("bvpq,bvq->bvp", inv_T[..., :3, :3], rooted) + inv_T[..., :3, 3]

        for _ in range(100):
            nn_w = nn_w + 0.1 * torch.einsum("vw,bwj->bvj", self.smooth_step, nn_w)
        zero_v = batch["zeropose_smpl_vertices"].reshape(B * T, -1, 3)
        Jp = torch.einsum("bvc,bjv->bjc", zero_v,
                          batch["J_regressor"].reshape(B * T, 24, -1))
        _, A = rigid_transform(rodrigues(batch["pose"].reshape(B * T, 24, 3)), Jp,
                               self.parents)
        Tm = torch.einsum("bvj,btjq->btvq", nn_w, A.reshape(B, T, 24, 16)).reshape(B, T, V, 4, 4)
        return torch.einsum("btvpq,bvq->btvp", Tm[..., :3, :3], unposed) + Tm[..., :3, 3]

    # --- refinement ------------------------------------------------------
    def _pe(self, name, table, xyz, centers, radius, nsample):
        idx = G.ball_query(radius, nsample, xyz, centers)
        g = G.gather_rows(table, idx)
        g = torch.cat([g[..., :3] - centers[:, :, None, :], g[..., 3:]], -1)
        h = torch.relu(self.linear(f"{name}/linear0", g))
        return self.linear(f"{name}/linear1", h).max(dim=2).values

    def refine(self, levels, body_v, body_vn, lbs_garment, B, T):
        """Three refinements from the LBS garment: -> [(B, T, V, 3)] per
        iteration."""
        s = self.sizes
        cur = lbs_garment.reshape(B * T, -1, 3)
        V = cur.shape[1]
        body_table = torch.cat([body_v, body_vn], -1)
        out, hidden = [], None
        for it in range(ITERATIONS):
            pieces = [cur]
            for i in range(3):
                pieces.append(self._pe(f"body_pe{i}", body_table, body_v, cur,
                                       s["body_radius"][i], s["body_nsample"][i]))
            for i, (lx, lf) in enumerate(levels):
                pieces.append(self._pe(f"garment_pe{i}", torch.cat([lx, lf], -1), lx, cur,
                                       s["garment_radius"][i], s["garment_nsample"][i]))
            if it > 0:
                qkv = hidden.reshape(B, T, V, HIDDEN) @ self.W[f"params/temporal_qkv{it - 1}/kernel"]
                q, k, v = (t.reshape(B, T, V * HIDDEN) for t in qkv.split(HIDDEN, -1))
                attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(T), dim=-1)
                pieces.append((attn @ v).reshape(B * T, V, HIDDEN))
            x = torch.cat(pieces, -1)
            for layer in range(4):
                name = f"params/gcn{it}_{layer}"
                x = torch.einsum("vw,bwc->bvc", self.gcn_adj, x @ self.W[f"{name}/weight"])
                x = x + self.W[f"{name}/bias"]
                if layer < 3:
                    x = torch.relu(x)
                if layer == 2:
                    hidden = x
            cur = cur + x
            out.append(cur.reshape(B, T, V, 3))
        return out

    def posed(self, pcd: torch.Tensor, batch: dict) -> dict:
        """The posed stage: the canonical stage (eval, no gradient), LBS,
        three refinements. -> the canonical outputs, `lbs` (B, T, V, 3) and
        `iters` [(B, T, V, 3)]."""
        B, T = pcd.shape[:2]
        with torch.no_grad():
            canon = self.canonical(pcd)
            body_v = batch["smpl_vertices"].reshape(B * T, -1, 3)
            body_vn = G.vertex_normals(body_v, self.body_faces)
            lbs = self.lbs(canon["tpose_garment"], batch)
        canon["lbs"] = lbs
        canon["iters"] = self.refine(canon["levels"], body_v, body_vn, lbs, B, T)
        return canon


@contextlib.contextmanager
def tf32():
    """Products in TF32 inside the block (the control: the precision below
    the configuration's float32)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
