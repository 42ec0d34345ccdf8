"""Neural-network building blocks."""

from garment4d_tpu_torch.nn.layers import (
    MLP,
    BatchNorm,
    ConvBNRelu,
    Dropout,
    GraphConvolution,
    SharedMLP,
)
from garment4d_tpu_torch.nn.pointnet import FPModule, SAModuleMSG

__all__ = ["MLP", "BatchNorm", "ConvBNRelu", "Dropout", "FPModule", "GraphConvolution",
           "SAModuleMSG", "SharedMLP"]
