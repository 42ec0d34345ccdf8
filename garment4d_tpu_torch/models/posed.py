"""Posed-stage garment model ("GarmentPCALBS").

Counterpart of `garment4d_tpu/models/posed.py` (reference
`modules/mesh_encoder.py:172-487`): the frozen canonical stage, interpolated
LBS of the canonical garment to every frame, then `iterations` rounds of
GCN refinement fed by multi-radius query-group PE blocks over the body
surface (xyz + vertex normals) and over the stage-1 garment point levels,
with single-head temporal attention across frames from iteration 2 on.

Submodules are named by the Flax paths (`canonical`, `body_pe0.linear0`,
`garment_pe2.linear1`, `temporal_qkv0`, `gcn1_0`, ...), so a Flax variables
npz loads through `train/convert.py`. In training (`train/step.py`) the
gradient flows through the refinement iterations only: the canonical stage
runs in eval mode under no_grad, LBS sees no trainable input, and the PE
tables (body and stage-1 garment levels) get no gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from garment4d_tpu_torch import ops
from garment4d_tpu_torch.models.assets import GarmentAssets
from garment4d_tpu_torch.models.canonical import (
    CanonicalGarmentModel,
    CanonicalOutput,
    FrozenCanonicalStage,
)
from garment4d_tpu_torch.models.skinning import LbsResult, lbs_garment_interpolation
from garment4d_tpu_torch.nn import GraphConvolution

# SMPL kinematic tree (smplx kintree_table[0])
_SMPL_PARENTS = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21], np.int64)
ITERATIONS = 3     # GCN refinement rounds (cfg.NETWORK.ITERATION)
FEAT_NUM = 32      # width of each PE block
HIDDEN_DIM = 128   # width of the GCN hidden layers and the temporal mix


@dataclasses.dataclass(frozen=True)
class BodyInputs:
    """The body data the posed stage reads."""

    pose: torch.Tensor                # (B, T, 72)
    smpl_vertices: torch.Tensor       # (B, T, Nb, 3) posed body
    tpose_vertices: torch.Tensor      # (B, Nb, 3)
    tpose_root_joints: torch.Tensor   # (B, 3)
    zeropose_vertices: torch.Tensor   # (B, T, Nb, 3)
    J_regressor: torch.Tensor         # (B, T, 24, Nb)
    lbs_weights: torch.Tensor         # (B, T, Nb, 24)


class PosedOutput(NamedTuple):
    canonical: CanonicalOutput
    lbs: LbsResult
    iter_garment_v: tuple  # per-iteration refined garments, each (B, T, Vg, 3)


class PEParams(nn.Module):
    """The 2-layer PE MLP's parameters (`linear0`, `linear1`); `kb()` gives
    them as (k0 (in, F), b0, k1 (F, F), b1)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.linear0 = nn.Linear(in_features, FEAT_NUM)
        self.linear1 = nn.Linear(FEAT_NUM, FEAT_NUM)

    def kb(self):
        return (self.linear0.weight.t(), self.linear0.bias,
                self.linear1.weight.t(), self.linear1.bias)


class SplitQueryGroupPE(PEParams):
    """Ball query over a stage-1 garment level, then the PE block with the
    first layer split around the gather (`ops.group_pe_max_split_frozen`)."""

    def __init__(self, in_features: int, radius: float, nsample: int):
        super().__init__(in_features)
        self.radius = radius
        self.nsample = nsample

    def forward(self, xyz: torch.Tensor, new_xyz: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        idx = ops.ball_query(self.radius, self.nsample, xyz, new_xyz)
        return ops.group_pe_max_split_frozen(xyz, features, idx, new_xyz, *self.kb())


class PosedGarmentModel(FrozenCanonicalStage):
    """Stage 2: point-cloud sequence + body -> posed garment sequence."""

    def __init__(self, assets: GarmentAssets, body_faces: np.ndarray,
                 lbs_k: int = 256, iterations: int = ITERATIONS):
        super().__init__()
        self.assets = assets
        self.lbs_k = lbs_k
        self.iterations = iterations
        self.canonical = CanonicalGarmentModel(assets)
        r = self.radii
        self.body_radius, self.body_nsample = r["body_radius"], r["body_nsample"]
        for i in range(3):
            self.add_module(f"body_pe{i}", PEParams(3 + 3))
        # stage-1 garment levels: 64, 96 and 384 feature channels
        for i, width in enumerate((64, 96, 384)):
            self.add_module(f"garment_pe{i}", SplitQueryGroupPE(
                3 + width, r["garment_radius"][i],
                r["garment_nsample"][i]))
        for i in range(iterations - 1):
            self.add_module(f"temporal_qkv{i}",
                            nn.Linear(HIDDEN_DIM, 3 * HIDDEN_DIM, bias=False))
        pe_width = 3 + 6 * FEAT_NUM
        for it in range(iterations):
            widths = (pe_width + (HIDDEN_DIM if it > 0 else 0), HIDDEN_DIM,
                      HIDDEN_DIM, HIDDEN_DIM, 3)
            for layer in range(4):
                self.add_module(f"gcn{it}_{layer}",
                                GraphConvolution(widths[layer], widths[layer + 1]))

        # constants (not state): body faces, smoothing operator, adjacency.
        # A template whose native order is not cyclic-banded runs the
        # refinement loop in the reverse Cuthill-McKee order that makes it so.
        adj = assets.gcn_adj
        self.diag_offsets = ops.cyclic_diagonals(adj)
        perm = None
        if self.diag_offsets is None:  # (None, None) when no order is banded
            perm, self.diag_offsets = ops.bandwidth_permutation(adj)
            if perm is not None:
                adj = adj[perm][:, perm]
        self.band_reordered = perm is not None
        self.register_buffer("body_faces", torch.from_numpy(
            np.asarray(body_faces, np.int64)), persistent=False)
        self.register_buffer("smooth_op", torch.from_numpy(
            np.ascontiguousarray(assets.smooth_op)), persistent=False)
        self.register_buffer("gcn_adj", torch.from_numpy(
            np.ascontiguousarray(adj)), persistent=False)
        if self.band_reordered:
            self.register_buffer("band_perm", torch.from_numpy(
                perm.astype(np.int64)), persistent=False)
            self.register_buffer("band_inv", torch.from_numpy(
                np.argsort(perm).astype(np.int64)), persistent=False)

    @property
    def radii(self):
        # reference `mesh_encoder.py:179-188`: trousers override sample counts
        if self.assets.name == "Trousers":
            return dict(garment_radius=(0.1, 0.2, 0.4), garment_nsample=(32, 8, 4),
                        body_radius=(0.1, 0.2, 0.4), body_nsample=(8, 16, 32))
        return dict(garment_radius=(0.1, 0.2, 0.4), garment_nsample=(32, 16, 8),
                    body_radius=(0.1, 0.2, 0.4), body_nsample=(8, 16, 32))

    def _temporal_mix(self, it: int, hidden: torch.Tensor, B: int, T: int) -> torch.Tensor:
        """Single-head attention over the T frames of each sequence, on the
        whole (Vg * hidden) feature, softmax(Q K^T / sqrt(T))."""
        Vg = hidden.shape[1]
        qkv = getattr(self, f"temporal_qkv{it - 1}")(
            hidden.reshape(B, T, Vg, HIDDEN_DIM))
        q, k, v = (t.reshape(B, T, Vg * HIDDEN_DIM)
                   for t in torch.split(qkv, HIDDEN_DIM, dim=-1))
        attn = torch.softmax(torch.einsum("btd,bsd->bts", q, k) / math.sqrt(T), dim=-1)
        mixed = torch.einsum("bts,bsd->btd", attn, v)
        return mixed.reshape(B * T, Vg, HIDDEN_DIM)

    def refine(self, it: int, cur: torch.Tensor, hidden, garment_xyz, garment_features,
               body_v: torch.Tensor, body_vn: torch.Tensor, B: int, T: int):
        """Refinement iteration `it`: body and garment PE blocks around the
        current garment vertices `cur` (B*T, Vg, 3), in the model's vertex
        order; the temporal-attention mix of the previous iteration's
        `hidden` from the second iteration on; the GCN stack. -> (vertex
        offsets (B*T, Vg, 3), hidden (B*T, Vg, HIDDEN_DIM))."""
        body_params = [getattr(self, f"body_pe{i}").kb() for i in range(3)]
        pieces = [cur]
        pieces.extend(ops.query_group_pe_multi(
            self.body_radius, self.body_nsample, body_v, cur, body_vn, body_params))
        for i in range(3):
            pieces.append(getattr(self, f"garment_pe{i}")(
                garment_xyz[i], cur, garment_features[i]))
        if it > 0:
            pieces.append(self._temporal_mix(it, hidden, B, T))
        layers = [getattr(self, f"gcn{it}_{l}") for l in range(4)]
        return ops.gcn_stack(
            pieces, [g.weight for g in layers], [g.bias for g in layers],
            self.gcn_adj, self.diag_offsets, (True, True, True, False), 2)

    def forward(self, x: torch.Tensor, body: BodyInputs) -> PosedOutput:
        """x: (B, T, N, 3) point-cloud sequence."""
        B, T = x.shape[:2]
        BT = B * T
        Vg = self.assets.num_verts

        with torch.no_grad():  # stage 1 is frozen
            canonical = self.canonical(x)

        body_v = body.smpl_vertices.reshape(BT, -1, 3)
        body_vn = ops.vertex_normals(body_v, self.body_faces)

        lbs = lbs_garment_interpolation(
            canonical.tpose_garment, body.tpose_vertices,
            body.tpose_root_joints, body.zeropose_vertices, body.pose,
            body.J_regressor, body.lbs_weights, parents=_SMPL_PARENTS,
            smooth_op=self.smooth_op, K=self.lbs_k)

        cur = lbs.posed_garment.reshape(BT, Vg, 3)
        if self.band_reordered:
            cur = cur[:, self.band_perm]
        iter_results, hidden = [], None
        for it in range(self.iterations):
            h, hidden = self.refine(it, cur, hidden, canonical.garment_xyz,
                                    canonical.garment_features, body_v, body_vn, B, T)
            cur = cur + h
            out_v = cur[:, self.band_inv] if self.band_reordered else cur
            iter_results.append(out_v.reshape(B, T, Vg, 3))
        return PosedOutput(canonical=canonical, lbs=lbs,
                           iter_garment_v=tuple(iter_results))
