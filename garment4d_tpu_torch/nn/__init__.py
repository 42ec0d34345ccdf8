"""Neural-network building blocks."""

from garment4d_tpu_torch.nn.layers import BatchNorm, ConvBNRelu, Dropout, SharedMLP
from garment4d_tpu_torch.nn.pointnet import FPModule, SAModuleMSG

__all__ = ["BatchNorm", "ConvBNRelu", "Dropout", "FPModule", "SAModuleMSG", "SharedMLP"]
