"""The plain reference's operations: FFTs, the k-space mask, warps, the
losses and the PBSpline augmentation, in plain PyTorch.

A frozen copy of the math of `spatialalignmentnetwork_tpu_torch/ops/`
(fft.py, masks.py's equispaced mask, grid_sample.py, ssim.py, crop.py,
bicubic.py), `models/stn.py::gradient_loss` and `data/augment.py` at
commit 3f2e19a. The warps are `F.grid_sample` and `F.affine_grid`, the
SSIM windows `F.avg_pool2d`: none of the port's kernels or plain versions.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def fft2(x):
    return torch.fft.fft2(x, norm="ortho")


def ifft2(x):
    return torch.fft.ifft2(x, norm="ortho")


def rss(x):
    """Root-sum-of-squares over dim 1, keepdim; 0 where the sum is 0 (a
    finite gradient there)."""
    mag2 = x.real ** 2 + x.imag ** 2 if x.is_complex() else x ** 2
    s = torch.sum(mag2, dim=1, keepdim=True)
    nz = s > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, s, torch.ones_like(s))), 0.0)


def identity_grid(shape, device):
    theta = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], device=device)
    return F.affine_grid(theta, (1, *shape[1:]), align_corners=False)


def warp(img, grid, padding_mode="zeros"):
    """Bilinear sampling, align_corners=False; a complex image as its real
    and imaginary planes."""
    if img.is_complex():
        c = img.shape[1]
        out = warp(torch.cat([img.real, img.imag], dim=1), grid, padding_mode)
        return torch.complex(out[:, :c], out[:, c:])
    return F.grid_sample(img, grid.to(img.dtype), mode="bilinear",
                         padding_mode=padding_mode, align_corners=False)


def gradient_loss(offset):
    dx = torch.abs(offset[:, :, 1:, :] - offset[:, :, :-1, :])
    dy = torch.abs(offset[:, 1:, :, :] - offset[:, :-1, :, :])
    return (torch.mean(dx * dx) + torch.mean(dy * dy)) / 2.0


def ssim_loss(X, Y, win=7, k1=0.01, k2=0.03):
    """1 - mean SSIM over the VALID 7x7 windows, unbiased covariances."""
    cn = win * win / (win * win - 1)
    c1, c2 = k1 ** 2, k2 ** 2

    def mean(t):
        return F.avg_pool2d(t, win, stride=1)

    ux, uy = mean(X), mean(Y)
    vx = cn * (mean(X * X) - ux * ux)
    vy = cn * (mean(Y * Y) - uy * uy)
    vxy = cn * (mean(X * Y) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return 1.0 - s.mean()


def equispaced_pruned(sparsity: float, shape: int, seed: int) -> np.ndarray:
    """The equispaced mask's pruned lines (True: zeroed), corner-DC: the
    ACS borders kept and equispaced lines from a start drawn by
    np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    center_len = int(round(shape * sparsity * 0.32))
    sl = slice(center_len // 2, center_len // 2 - center_len)
    pruned = np.zeros(shape, dtype=bool)
    pruned[sl] = True
    remaining = math.floor(sparsity * shape - center_len)
    interval = int((shape - center_len - 1) // (remaining - 1))
    start_max = (shape - center_len) - ((remaining - 1) * interval + 1)
    start = int(rng.integers(0, start_max + 1))
    part = pruned[sl].copy()
    n = part.shape[0]
    part = np.roll(part, n // 2)
    part[start: start + interval * remaining: interval] = False
    pruned[sl] = np.roll(part, (n + 1) // 2)
    return pruned


def center_crop(x, size):
    h, w = x.shape[-2:]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top: top + size, left: left + size]


def pbspline(batch, draws):
    """Warp every modality of `batch` by one grid: the rigid transform of
    draws "r" (angles) and "t" (the shift on both axes) plus the 9x9
    control offsets "ctrl" upsampled bicubically; reflection padding."""
    n, c, h, w = batch[0].shape
    cos, sin, t = torch.cos(draws["r"]), torch.sin(draws["r"]), draws["t"]
    theta = torch.stack([torch.stack([cos, -sin, t], -1), torch.stack([sin, cos, t], -1)], 1)
    grid = F.affine_grid(theta, (n, c, h, w), align_corners=False)
    grid = grid + F.interpolate(draws["ctrl"], size=(h, w), mode="bicubic",
                                align_corners=False).permute(0, 2, 3, 1)
    return [warp(x, grid, "reflection") for x in batch]
