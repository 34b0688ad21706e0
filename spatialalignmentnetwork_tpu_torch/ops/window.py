"""Windowed sums, pooling and smoothing for the window losses (counterpart
of the JAX package's `ops/window.py`).

A window sum is two separable depthwise convolutions with ones kernels,
along H then along W, as in the JAX package, so the cost per pixel is
O(win) instead of O(win^2).

The JAX helpers pin `precision=HIGHEST`; on the card cuDNN runs f32
convolutions in TF32 unless told otherwise, so every convolution here
runs with `torch.backends.cudnn.allow_tf32` off, whatever the caller set
(library callers never build a `CSModel`, which pins it for its nets).
That holds for the backward too: autograd runs a convolution's backward
after the forward has returned, under whatever flag is set then, so each
convolution here is an autograd Function whose backward turns TF32 off
again itself.
"""

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32_convs():
    """cuDNN at true f32 (no TF32) inside, the caller's setting after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _F32Conv(torch.autograd.Function):
    """F.conv2d with cuDNN's TF32 off in the forward and in the backward."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, groups)
        with f32_convs():
            return F.conv2d(x, weight, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        dx = dw = None
        with f32_convs():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, weight, g, stride, padding,
                                                groups=groups)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, weight.shape, g, stride, padding,
                                                 groups=groups)
        return dx, dw, None, None, None


def _conv(x, weight, stride=1, padding=0, groups=1):
    return _F32Conv.apply(x, weight, stride, padding, groups)


def window_sum2d(x: torch.Tensor, win: int, padding: str = "VALID") -> torch.Tensor:
    """Sum over win x win spatial windows of an [N, C, H, W] tensor.

    padding "VALID" (output H - win + 1) or "SAME" (zero-padded by win // 2
    on each side, as a conv2d with padding=win//2 for odd win)."""
    if padding == "VALID":
        pad = 0
    elif padding == "SAME":
        pad = win // 2
    else:
        raise ValueError(f"unknown padding {padding!r}")
    c = x.shape[1]
    ones_h = torch.ones((c, 1, win, 1), dtype=x.dtype, device=x.device)
    ones_w = torch.ones((c, 1, 1, win), dtype=x.dtype, device=x.device)
    x = _conv(x, ones_h, padding=(pad, 0), groups=c)
    return _conv(x, ones_w, padding=(0, pad), groups=c)


def avg_pool2d_nchw(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k stride-k average pooling over [N, C, H, W] (a trailing row or
    column that fills no window is dropped)."""
    c = x.shape[1]
    ones = torch.ones((c, 1, k, k), dtype=x.dtype, device=x.device)
    return _conv(x, ones, stride=k, groups=c) / (k * k)


def conv2d_same_nchw(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D convolution of [N, C, H, W] with one [kh, kw] kernel
    shared across channels, zero "same" padding (odd kernels)."""
    kh, kw = kernel2d.shape
    c = x.shape[1]
    k = kernel2d.to(dtype=x.dtype, device=x.device)[None, None].expand(c, 1, kh, kw)
    return _conv(x, k, padding=(kh // 2, kw // 2), groups=c)
