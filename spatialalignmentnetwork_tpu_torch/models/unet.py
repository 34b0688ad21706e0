"""fastMRI-style U-Net and its complex-input Norm wrapper (counterpart of
the JAX package's `models/unet.py`, plain layout).

`Unet` keeps the reference torch module names (`down_sample_layers`,
`conv`, `up_transpose_conv`, `up_conv`), whose numbering differs from
execution order: `conv` is the bottleneck and `up_conv.{last}.1` the 1x1
head. `NormUnet` adapts it to complex [N, C, H, W] input: real/imag
channels, two-group normalisation, pad to a multiple of 16 and an optional
instance-normalised reference channel.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvBlock, TransposeConvBlock, avg_pool2, instance_norm, stat_dtype


class Unet(nn.Module):
    """U-Net over real NCHW tensors. Encoder: ConvBlock then 2x2 avg-pool
    per level; bottleneck ConvBlock; decoder: TransposeConvBlock,
    reflect-pad right/bottom when the skip is larger, concat skip,
    ConvBlock; final 1x1 conv with bias."""

    def __init__(self, in_chans: int, out_chans: int, chans: int = 32,
                 num_pool_layers: int = 4):
        super().__init__()
        self.down_sample_layers = nn.ModuleList([ConvBlock(in_chans, chans)])
        ch = chans
        for _ in range(num_pool_layers - 1):
            self.down_sample_layers.append(ConvBlock(ch, ch * 2))
            ch *= 2
        self.conv = ConvBlock(ch, ch * 2)
        self.up_conv = nn.ModuleList()
        self.up_transpose_conv = nn.ModuleList()
        for _ in range(num_pool_layers - 1):
            self.up_transpose_conv.append(TransposeConvBlock(ch * 2, ch))
            self.up_conv.append(ConvBlock(ch * 2, ch))
            ch //= 2
        self.up_transpose_conv.append(TransposeConvBlock(ch * 2, ch))
        self.up_conv.append(
            nn.Sequential(ConvBlock(ch * 2, ch), Conv2d(ch, out_chans, 1))
        )

    def forward(self, x):
        stack = []
        for layer in self.down_sample_layers:
            x = layer(x)
            stack.append(x)
            x = avg_pool2(x)
        x = self.conv(x)
        for transpose_conv, conv in zip(self.up_transpose_conv, self.up_conv):
            skip = stack.pop()
            x = transpose_conv(x)
            pad_w = skip.shape[-1] - x.shape[-1]
            pad_h = skip.shape[-2] - x.shape[-2]
            if pad_w or pad_h:
                x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
            x = conv(torch.cat([x, skip], dim=1))
        return x


def group_norm_2(x: torch.Tensor, eps: float = 1e-6):
    """Normalize an [N, C, H, W] real tensor in two groups (first/second
    half of channels = real/imag parts) by mean and UNBIASED std, two-pass.

    A zero-variance group gets std 0 through the same guard as the JAX
    package. The statistics are taken in at least f32 and applied in x's
    dtype. Returns (normalized, mean [N,2,1,1], std [N,2,1,1]).
    """
    b, c, h, w = x.shape
    g = x.reshape(b, 2, (c // 2) * h * w)
    var, mean = torch.var_mean(g.to(stat_dtype(x.dtype)), dim=2, correction=1)
    nz = var > 0
    std = torch.where(nz, torch.sqrt(torch.where(nz, var, 1.0)), 0.0)
    mean = mean.to(x.dtype).reshape(b, 2, 1, 1)
    std = std.to(x.dtype).reshape(b, 2, 1, 1)
    xn = (x.reshape(b, 2, c // 2, h, w) - mean[:, :, None]) / (
        std[:, :, None] + eps
    )
    return xn.reshape(b, c, h, w), mean, std


def pad_to_16(x: torch.Tensor):
    """Center-pad H and W up to the next multiple of 16."""
    _, _, h, w = x.shape
    w_mult = ((w - 1) | 15) + 1
    h_mult = ((h - 1) | 15) + 1
    w_pad = ((w_mult - w) // 2, (w_mult - w) - (w_mult - w) // 2)
    h_pad = ((h_mult - h) // 2, (h_mult - h) - (h_mult - h) // 2)
    x = F.pad(x, (*w_pad, *h_pad))
    return x, (h_pad, w_pad, h_mult, w_mult)


def unpad_16(x, h_pad, w_pad, h_mult, w_mult):
    return x[..., h_pad[0]: h_mult - h_pad[1], w_pad[0]: w_mult - w_pad[1]]


class NormUnet(nn.Module):
    """U-Net wrapper for complex NCHW input: complex -> [real; imag]
    channels -> 2-group norm -> pad to /16 -> (optional ref channel,
    instance-normalised) -> Unet -> unpad -> unnorm -> complex.

    With `ref_prenormalized` the ref arrives already instance-normalised
    and padded (a caller running many cascades on one ref hoists both)."""

    def __init__(self, chans: int, num_pools: int, in_chans: int = 1,
                 out_chans: int = 1, use_ref: bool = False,
                 ref_prenormalized: bool = False):
        super().__init__()
        self.in_chans = in_chans
        self.out_chans = out_chans
        self.use_ref = use_ref
        self.ref_prenormalized = ref_prenormalized
        self.unet = Unet(
            in_chans=2 * in_chans + (1 if use_ref else 0),
            out_chans=2 * out_chans,
            chans=chans,
            num_pool_layers=num_pools,
        )

    def forward(self, x: torch.Tensor, ref: Optional[torch.Tensor] = None):
        if x.ndim != 4 or not x.is_complex() or x.shape[1] != self.in_chans:
            raise ValueError(
                f"NormUnet expects complex [N, {self.in_chans}, H, W], got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        x = torch.cat([x.real, x.imag], dim=1)
        x, mean, std = group_norm_2(x)
        x, pad_sizes = pad_to_16(x)
        if self.use_ref:
            if ref is None or ref.is_complex():
                raise ValueError("use_ref needs a real ref image")
            if not self.ref_prenormalized:
                ref, _ = pad_to_16(instance_norm(ref))
            x = torch.cat([x, ref], dim=1)
        elif ref is not None:
            raise ValueError("ref given to a NormUnet without use_ref")
        x = unpad_16(self.unet(x), *pad_sizes)
        b, c, h, w = x.shape
        x = x.reshape(b, 2, c // 2, h, w) * std[:, :, None] + mean[:, :, None]
        x = x.reshape(b, c, h, w)
        c = c // 2
        return torch.complex(x[:, :c], x[:, c:])
