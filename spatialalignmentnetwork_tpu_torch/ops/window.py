"""Windowed sums, pooling and smoothing for the window losses (counterpart
of the JAX package's `ops/window.py`).

A window sum is two separable depthwise convolutions with ones kernels,
along H then along W, as in the JAX package, so the cost per pixel is
O(win) instead of O(win^2).

The JAX helpers pin `precision=HIGHEST`; on the card cuDNN runs f32
convolutions in TF32 unless told otherwise, so every convolution here
runs with `torch.backends.cudnn.allow_tf32` off, whatever the caller set
(library callers never build a `CSModel`, which pins it for its nets).
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
    with f32_convs():
        x = F.conv2d(x, ones_h, padding=(pad, 0), groups=c)
        return F.conv2d(x, ones_w, padding=(0, pad), groups=c)


def avg_pool2d_nchw(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k stride-k average pooling over [N, C, H, W] (a trailing row or
    column that fills no window is dropped)."""
    c = x.shape[1]
    ones = torch.ones((c, 1, k, k), dtype=x.dtype, device=x.device)
    with f32_convs():
        s = F.conv2d(x, ones, stride=k, groups=c)
    return s / (k * k)


def conv2d_same_nchw(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D convolution of [N, C, H, W] with one [kh, kw] kernel
    shared across channels, zero "same" padding (odd kernels)."""
    kh, kw = kernel2d.shape
    c = x.shape[1]
    k = kernel2d.to(dtype=x.dtype, device=x.device)[None, None].expand(c, 1, kh, kw)
    with f32_convs():
        return F.conv2d(x, k, padding=(kh // 2, kw // 2), groups=c)
