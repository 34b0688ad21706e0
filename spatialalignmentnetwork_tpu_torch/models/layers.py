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

In true f32 on the card, `ConvBlock`'s 3x3 convs (`Conv3x3`) run the
port's 3xTF32 kernel channels-last, and what follows them (norms,
activations, pooling, concatenation, the transpose convs) keeps that
layout; everywhere else every conv is cuDNN's (or the CPU's) in NCHW.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv import conv3x3_op


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


class Conv3x3(Conv2d):
    """A 3x3 stride-1 SAME conv without bias (ConvBlock's), routed through
    the port's 3xTF32 kernel (`kernels/conv.py`, op `san::conv3x3`) where
    `routed` holds, and Conv2d's forward elsewhere. The kernel is NHWC:
    its operand is a view of the input made channels-last (a copy only
    where it is not), its output is returned as a channels-last NCHW view.
    Its weight is an HWIO view of this one, which the op copies to HWIO;
    without a gradient to take, that copy is made once a weight version
    (`_hwio`) instead of once a call."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__(in_chans, out_chans, 3, padding=1, bias=False)
        self._hwio_copy = None

    def routed(self, x) -> bool:
        """Whether x takes the kernel: a CUDA f32 input computed in f32
        (no compute dtype) with cuDNN's TF32 off (the port's true f32,
        where the kernel beats cuDNN), on even H and W (the kernel's
        planes). Under TF32 cuDNN is the faster, and bf16 stays on it."""
        return (self.compute_dtype is None and x.dtype == torch.float32
                and x.device.type == "cuda" and not torch.backends.cudnn.allow_tf32
                and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0)

    def _hwio(self, x):
        """The op's weight: an HWIO view that autograd follows where a
        gradient may be taken or the call is traced (x or the weight not a
        plain tensor: torch.export's fakes), and for a weight made in
        inference mode (which keeps no version), else a contiguous HWIO copy
        kept until the weight's storage or version changes (an optimizer
        step, a load, a move), or inference mode is entered or left. The
        copy holds an alias of the storage it was made from, so a new
        storage cannot take that one's address while the copy is kept."""
        w = self.weight
        view = w.permute(2, 3, 1, 0)
        if (torch.is_grad_enabled() and w.requires_grad) or type(x) is not torch.Tensor \
                or type(w) is not nn.Parameter or w.is_inference():
            return view
        key = (w.data_ptr(), w.dtype, w._version, torch.is_inference_mode_enabled())
        if self._hwio_copy is None or self._hwio_copy[0] != key:
            self._hwio_copy = (key, view.detach().contiguous(), w.detach())
        return self._hwio_copy[1]

    def forward(self, x):
        if not self.routed(x):
            return super().forward(x)
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return conv3x3_op(nhwc, self._hwio(x)).permute(0, 3, 1, 2)


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
    the fastMRI U-Net basic block. `layers.0` and `layers.3` are the convs
    (`Conv3x3`)."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.layers = nn.Sequential(
            Conv3x3(in_chans, out_chans),
            InstanceNorm(),
            nn.LeakyReLU(0.2),
            Conv3x3(out_chans, out_chans),
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
