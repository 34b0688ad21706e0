"""Shared building blocks (counterpart of the JAX package's
`models/layers.py`).

NCHW throughout, PyTorch's habit; the JAX package runs NHWC inside its
modules and the two meet at the public model boundaries. Module and
parameter names follow the reference torch fastMRI blocks, so a
`state_dict` reads like the reference's.
"""

import torch
import torch.nn.functional as F
from torch import nn


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm without affine parameters over [N, C, H, W]: each
    (sample, channel) plane by its mean and biased variance, two-pass."""
    var, mean = torch.var_mean(x, dim=(-2, -1), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    """`instance_norm` as a stateless module (no state_dict entries)."""

    def forward(self, x):
        return instance_norm(x)


class ConvBlock(nn.Module):
    """Two (conv3x3 no-bias -> InstanceNorm -> LeakyReLU(0.2)) stages:
    the fastMRI U-Net basic block. `layers.0` and `layers.3` are the convs."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(in_chans, out_chans, 3, padding=1, bias=False),
            InstanceNorm(),
            nn.LeakyReLU(0.2),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            InstanceNorm(),
            nn.LeakyReLU(0.2),
        )

    def forward(self, x):
        return self.layers(x)


class TransposeConvBlock(nn.Module):
    """ConvTranspose 2x2 stride-2 (no bias) -> InstanceNorm ->
    LeakyReLU(0.2)."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.ConvTranspose2d(in_chans, out_chans, 2, stride=2, bias=False),
            InstanceNorm(),
            nn.LeakyReLU(0.2),
        )

    def forward(self, x):
        return self.layers(x)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pooling (odd sizes floor), NCHW."""
    return F.avg_pool2d(x, 2, stride=2)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NCHW."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
