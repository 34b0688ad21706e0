"""Windowed sums for the window losses (counterpart of the JAX package's
`ops/window.py::window_sum2d`).

A window sum is two separable depthwise convolutions with ones kernels,
along H then along W, as in the JAX package, so the cost per pixel is
O(win) instead of O(win^2).
"""

import torch
import torch.nn.functional as F


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
    x = F.conv2d(x, ones_h, padding=(pad, 0), groups=c)
    return F.conv2d(x, ones_w, padding=(0, pad), groups=c)
