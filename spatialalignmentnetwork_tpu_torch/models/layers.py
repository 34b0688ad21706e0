"""Shared building blocks (counterpart of the JAX package's
`models/layers.py`).

NCHW throughout, PyTorch's habit; the JAX package runs NHWC inside its
modules and the two meet at the public model boundaries. Module and
parameter names follow the reference torch fastMRI blocks, so a
`state_dict` reads like the reference's.

The bf16 policy (the JAX package's `cfg.use_amp`, flax's `dtype` with
its default `param_dtype` float32) is each conv's `compute_dtype`: its
input, weight and bias are cast to it and its output comes out in it,
while the parameters stay f32. Norms take their statistics in at least
f32 and return their input's dtype (BatchNorm the compute dtype, as
flax's). `set_compute_dtype` sets it on every module of a net.
"""

import torch
import torch.nn.functional as F
from torch import nn


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype norms take their statistics in: at least f32."""
    return torch.promote_types(dtype, torch.float32)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm without affine parameters over [N, C, H, W]: each
    (sample, channel) plane by its mean and biased variance, two-pass,
    in at least f32; the output in x's dtype."""
    xf = x.to(stat_dtype(x.dtype))
    var, mean = torch.var_mean(xf, dim=(-2, -1), correction=0, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of every module of `module` that has one:
    bf16, or f32 (or None), which computes in the parameters' own dtype
    (a float64 copy of a net then runs in float64)."""
    dtype = None if dtype in (None, torch.float32) else dtype
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


def _cast(dtype, *tensors):
    return [None if t is None else t.to(dtype) for t in tensors]


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` where one is set (flax's
    `nn.Conv(dtype=...)`: input, weight and bias cast to it)."""

    compute_dtype = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return self._conv_forward(*_cast(self.compute_dtype, x, self.weight, self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (no output_size) computing in `compute_dtype`
    where one is set."""

    compute_dtype = None

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


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
            Conv2d(in_chans, out_chans, 3, padding=1, bias=False),
            InstanceNorm(),
            nn.LeakyReLU(0.2),
            Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
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
            ConvTranspose2d(in_chans, out_chans, 2, stride=2, bias=False),
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
