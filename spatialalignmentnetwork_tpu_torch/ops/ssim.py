"""SSIM training loss (counterpart of the JAX package's `ops/ssim.py`).

The reference recon loss (ssimloss.py:11-40): 7x7 uniform window, k1 0.01,
k2 0.03, data range 1, unbiased covariance normalization NP/(NP-1), VALID
windows, loss = 1 - mean(S).

  * ssim_map: the per-window SSIM map in plain torch (window sums from
    `ops/window.py`), any window and constants.
  * ssimloss: the loss through the autograd Function of `kernels/ssim.py`:
    the CUDA kernels forward and backward on CUDA tensors, their plain
    versions on CPU tensors.
  * ssim_per_plane: the mean of the map over each plane's VALID windows,
    from one launch of the forward kernel (the plain version on the CPU);
    the eval metrics and the eval step's loss_sim read it.
"""

import torch

from ..kernels import on_card
from ..kernels import ssim as kssim


def ssim_map(X: torch.Tensor, Y: torch.Tensor, win_size: int = 7,
             k1: float = 0.01, k2: float = 0.03,
             data_range: float = 1.0) -> torch.Tensor:
    """Per-window SSIM map over VALID windows of real [N, C, H, W] tensors."""
    return kssim.ssim_terms(X, Y, win_size, k1, k2, data_range)["S"]


def ssimloss(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """1 - mean SSIM of real [N, C, H, W] tensors (a 0-dim tensor),
    differentiable in both."""
    if X.is_complex() or Y.is_complex():
        raise TypeError("ssimloss takes real images")
    return kssim.SSIMLoss.apply(X, Y)


def ssim_per_plane(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over the VALID windows of each plane of real [N, C, H, W]
    tensors -> [N, C] f32: the per-plane sums of `ssim_fwd_cuda` on a
    card (`ssim_fwd_plain` on the CPU) over the windows a plane holds. No
    gradient."""
    if X.is_complex() or Y.is_complex():
        raise TypeError("ssim_per_plane takes real images")
    kssim._check(X, Y)
    fwd = kssim.ssim_fwd_cuda if on_card(X) else kssim.ssim_fwd_plain
    _, _, h, w = X.shape
    with torch.no_grad():
        return fwd(X.contiguous(), Y.contiguous()) / (
            (h - kssim.WIN + 1) * (w - kssim.WIN + 1))
