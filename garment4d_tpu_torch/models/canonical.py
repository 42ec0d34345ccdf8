"""Canonical-stage garment model ("GarmentPCA").

Counterpart of `garment4d_tpu/models/canonical.py` (reference
PCAGarmentEncoderSeg): per-frame PointNet++ semantic segmentation,
fixed-size garment point selection from the predicted labels, a 2-stage MSG
garment encoder with a global summary, temporal max-pool, and a small head
regressing PCA coefficients of the canonical garment mesh. With `only_seg`
the forward stops after the segmentation. In training (`train()`) the
BatchNorms use batch statistics and the head's dropout draws from the
generator passed to `forward`. With `compute_dtype` (bf16 under `--bf16`)
the backbone and the garment encoder compute their dense stacks in it, as
the JAX package's; the PCA head, the geometry and every output are fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from garment4d_tpu_torch.models.assets import GarmentAssets
from garment4d_tpu_torch.models.backbone import BackboneOutput, PointNet2SegBackbone
from garment4d_tpu_torch.nn import ConvBNRelu, SAModuleMSG
from garment4d_tpu_torch.nn.pointnet import max_over


def select_garment_points(xyz: torch.Tensor, features: torch.Tensor,
                          labels: torch.Tensor, garment_label: int, n: int):
    """The first `n` points with label == garment_label in index order,
    zero-padded when fewer: xyz (B, N, 3), features (B, N, C), labels (B, N)
    -> ((B, n, 3), (B, n, C)). Static shapes: the (s+1)-th garment point is
    found by a search on the cumulative label count."""
    cum = torch.cumsum((labels == garment_label).to(torch.int32), dim=-1,
                       dtype=torch.int32)
    targets = torch.arange(1, n + 1, dtype=torch.int32, device=xyz.device)
    idx = torch.searchsorted(cum, targets.expand(cum.shape[0], n).contiguous())
    valid = targets[None, :] <= cum[:, -1:]  # (B, n)
    idx = torch.where(valid, idx, torch.zeros_like(idx))

    def take(points):
        got = torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))
        return torch.where(valid[..., None], got, torch.zeros_like(got))

    return take(xyz), take(features)


class CanonicalOutput(NamedTuple):
    backbone: BackboneOutput
    garment_xyz: tuple                      # garment-encoder per-level xyz
    garment_features: tuple                 # garment-encoder per-level features
    garment_summary: Optional[torch.Tensor]  # (B, T, 512); None with only_seg
    pca_coeff: Optional[torch.Tensor]       # (B, pca_dim)
    tpose_garment: Optional[torch.Tensor]   # (B, V, 3)


class CanonicalGarmentModel(nn.Module):
    """Stage 1: point-cloud sequence -> canonical garment mesh.

    Submodules are named by the Flax paths (`pointnet.sa1.mlp0.layer0.conv`,
    `garment_sa1`, `pca_head0`, ...)."""

    def __init__(self, assets: GarmentAssets, only_seg: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.garment_label = assets.label
        self.only_seg = only_seg
        self.compute_dtype = d = compute_dtype
        self.pointnet = PointNet2SegBackbone(compute_dtype=d)
        if not only_seg:  # unused there, so absent, as in the Flax model
            # garment encoder widths per reference `mesh_encoder.py:54-78`
            self.garment_sa1 = SAModuleMSG(512, (0.05, 0.1), (16, 32),
                                           ((32, 32), (64, 64)), 64, d)
            self.garment_sa2 = SAModuleMSG(64, (0.2, 0.4), (32, 64),
                                           ((128, 128), (256, 256)), 96, d)
            self.garment_summarize = SAModuleMSG(None, (None,), (None,),
                                                 ((512, 512),), 384, d)
            # the reference's raw Conv1d keeps its bias under the BatchNorm
            self.pca_head0 = ConvBNRelu(512, 128, bn=True, bias=True)
            self.pca_head1 = ConvBNRelu(128, 64, bn=True, bias=True)
            self.pca_head2 = ConvBNRelu(64, assets.pca_dim, bn=False, relu=False)
        # constants, not state: the checkpoint carries weights only
        self.register_buffer("pca_components",
                             torch.from_numpy(assets.pca_components.copy()),
                             persistent=False)
        self.register_buffer("pca_mean", torch.from_numpy(assets.pca_mean.copy()),
                             persistent=False)
        self.register_buffer("pca_scale", torch.from_numpy(assets.pca_scale.copy()),
                             persistent=False)

    def pca_inverse_transform(self, coeff: torch.Tensor) -> torch.Tensor:
        """(B, pca_dim) -> (B, V, 3)."""
        flat = (coeff @ self.pca_components + self.pca_mean) * self.pca_scale
        return flat.reshape(coeff.shape[0], -1, 3)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> CanonicalOutput:
        """x: (B, T, N, 3) point-cloud sequence; `generator` feeds the
        dropout in training."""
        B, T, N, C = x.shape
        backbone = self.pointnet(x.reshape(B * T, N, C), generator)
        if self.only_seg:
            return CanonicalOutput(backbone, (), (), None, None, None)

        labels = torch.argmax(backbone.sem_logits.detach(), dim=-1)
        garment_v, garment_f = select_garment_points(
            backbone.xyz[0], backbone.features[0], labels, self.garment_label,
            N // 4)

        g_xyz, g_feat = [garment_v], [garment_f]
        for enc in (self.garment_sa1, self.garment_sa2):
            xyz_i, feat_i = enc(g_xyz[-1], g_feat[-1])
            g_xyz.append(xyz_i)
            g_feat.append(feat_i)
        _, summary = self.garment_summarize(g_xyz[-1], g_feat[-1])
        summary = summary.reshape(B, T, 512)

        pooled = max_over(summary, 1, self.compute_dtype)  # temporal max-pool (B, 512)
        if self.compute_dtype is not None:
            # the PCA head and the outputs are fp32
            summary, pooled = summary.float(), pooled.float()
            g_feat = [f.float() for f in g_feat]
        coeff = self.pca_head2(self.pca_head1(self.pca_head0(pooled)))
        return CanonicalOutput(
            backbone=backbone,
            garment_xyz=tuple(g_xyz),
            garment_features=tuple(g_feat),
            garment_summary=summary,
            pca_coeff=coeff,
            tpose_garment=self.pca_inverse_transform(coeff),
        )


class FrozenCanonicalStage(nn.Module):
    """Base of the posed-stage models (`PosedGarmentModel`,
    `MgnGarmentModel`), whose `canonical` submodule is the frozen stage 1:
    it stays in eval mode when the model trains and runs under no_grad in
    their forwards."""

    canonical: CanonicalGarmentModel

    def train(self, mode: bool = True):
        """The canonical stage stays frozen in eval mode."""
        super().train(mode)
        self.canonical.eval()
        return self

    def freeze_canonical(self) -> None:
        """No gradient and no update for the canonical stage's parameters
        (it already runs under no_grad in eval mode in `forward`)."""
        for p in self.canonical.parameters():
            p.requires_grad_(False)
