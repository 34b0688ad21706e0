"""Spatial alignment network: dense deformable 2-D registration
(counterpart of the JAX package's `models/stn.py`).

A LibUNet over the concatenated (moving, fixed) magnitude images, then
LeakyReLU(0.01) and a 3x3 conv head predicting a 2-channel displacement
field; warping is bilinear grid sampling (align_corners=False, zeros).
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grid_sample import grid_sample, identity_grid
from .layers import Conv2d
from .unet_lib import LibUNet


class SpatialTransformer(nn.Module):
    """Predict (offset, grid) warping `moving` onto `fixed`.

    Inputs are real NCHW [N, channels, H, W]; offset and grid are
    [N, H, W, 2] with channel 0 = x (width) displacement in normalized
    [-1, 1] coordinates, and stay f32.
    """

    def __init__(self, channels: int = 1, feat: int = 32,
                 layers: Sequence[int] = (32, 64, 64, 64, 64)):
        super().__init__()
        self.unet = LibUNet(2 * channels, feat, layers)
        self.head = Conv2d(feat, 2, 3, padding=1)

    def forward(self, moving: torch.Tensor, fixed: torch.Tensor):
        if moving.ndim != 4 or moving.is_complex():
            raise ValueError("moving must be a real [N, C, H, W] tensor")
        x = self.unet(torch.cat([moving, fixed], dim=1))
        offset = self.head(F.leaky_relu(x, 0.01))
        offset = offset.permute(0, 2, 3, 1).to(torch.float32)
        grid = identity_grid(moving.shape, torch.float32, moving.device) + offset
        return offset, grid


def warp(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear warp with zero padding, align_corners=False."""
    return grid_sample(img, grid, padding_mode="zeros")


def _squared_differences(offset: torch.Tensor):
    """Squared forward differences of a displacement field [N, H, W, 2]
    along its width and its height."""
    if offset.shape[-1] != 2:
        raise ValueError("not a 2-D grid")
    dx = torch.abs(offset[:, :, 1:, :] - offset[:, :, :-1, :])
    dy = torch.abs(offset[:, 1:, :, :] - offset[:, :-1, :, :])
    return dx * dx, dy * dy


def gradient_loss(offset: torch.Tensor) -> torch.Tensor:
    """Smoothness penalty: mean squared forward differences of the
    displacement field [N, H, W, 2]."""
    dx2, dy2 = _squared_differences(offset)
    return (torch.mean(dx2) + torch.mean(dy2)) / 2.0


def gradient_loss_per_sample(offset: torch.Tensor) -> torch.Tensor:
    """`gradient_loss` of each sample of [N, H, W, 2] alone -> [N]."""
    dx2, dy2 = _squared_differences(offset)
    return (torch.mean(dx2, dim=(1, 2, 3)) + torch.mean(dy2, dim=(1, 2, 3))) / 2.0
