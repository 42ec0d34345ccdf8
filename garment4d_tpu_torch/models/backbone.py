"""PointNet++ multi-scale-grouping semantic-segmentation backbone.

Counterpart of `garment4d_tpu/models/backbone.py` (reference Pointnet2MSGSEG):
3 MSG set-abstraction stages (1024/256/64 centres), 3 feature-propagation
stages and a Conv-Dropout-Conv head over 7 classes, as the canonical model
uses it (no global stage: `global_feat=False`). Channel-last throughout.
The head's dropout draws from the `torch.Generator` the caller passes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from garment4d_tpu_torch.models.assets import CLASS_NUM
from garment4d_tpu_torch.nn import ConvBNRelu, Dropout, FPModule, SAModuleMSG


class BackboneOutput(NamedTuple):
    sem_logits: torch.Tensor             # (B, N, num_classes)
    features: tuple                      # per-level features, [0] = (B, N, 64)
    xyz: tuple                           # per-level xyz, [0] = input (B, N, 3)


class PointNet2SegBackbone(nn.Module):
    def __init__(self):
        super().__init__()
        # widths and radii per reference `pointnet2encoder.py:41-101`
        self.sa1 = SAModuleMSG(1024, (0.05, 0.1), (16, 32),
                               ((16, 16, 32), (32, 32, 64)), 0)
        self.sa2 = SAModuleMSG(256, (0.1, 0.2), (16, 32),
                               ((32, 32, 64), (64, 64, 128)), 96)
        self.sa3 = SAModuleMSG(64, (0.2, 0.4), (32, 64),
                               ((64, 64, 128), (128, 128, 256)), 192)
        self.fp1 = FPModule((128, 64), 128)
        self.fp2 = FPModule((256, 128), 256 + 96)
        self.fp3 = FPModule((512, 256), 384 + 192)
        self.head0 = ConvBNRelu(64, 32, bn=True)
        self.dropout = Dropout(0.5)
        self.head1 = ConvBNRelu(32, CLASS_NUM, bn=False, relu=False)

    def forward(self, pointcloud: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> BackboneOutput:
        """pointcloud (B, N, 3) -> BackboneOutput; `generator` feeds the
        head's dropout in training."""
        l_xyz, l_features = [pointcloud.contiguous()], [None]
        for sa in (self.sa1, self.sa2, self.sa3):
            li_xyz, li_feat = sa(l_xyz[-1], l_features[-1])
            l_xyz.append(li_xyz)
            l_features.append(li_feat)

        fps = (self.fp1, self.fp2, self.fp3)
        for i in range(-1, -4, -1):  # top-down: coarse -> fine
            l_features[i - 1] = fps[i](l_xyz[i - 1], l_xyz[i], l_features[i - 1],
                                       l_features[i])

        x = self.dropout(self.head0(l_features[0]), generator)
        sem_logits = self.head1(x)
        return BackboneOutput(sem_logits=sem_logits, features=tuple(l_features),
                              xyz=tuple(l_xyz))
