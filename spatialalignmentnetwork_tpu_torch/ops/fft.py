"""k-space <-> image-space primitives (counterpart of the JAX package's
`ops/fft.py`).

Conventions:
  * fft2/ifft2 are orthonormal ("ortho") 2-D transforms over the trailing
    two axes of an [N, C, H, W] tensor, with NO fftshift: the DC component
    lives at index (0, 0) ("corner-DC" layout), and undersampling masks
    follow the same layout (low frequencies at the borders of the W axis).
  * fftshift2/ifftshift2 are roll-based half-shifts, for visualisation.
  * rss is the root-sum-of-squares coil combination over dim 1, keepdim,
    real even for complex input.
"""

import torch


def fft2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D FFT over the last two axes. x: [N, C, H, W]."""
    if x.ndim != 4:
        raise ValueError(f"fft2 expects [N, C, H, W], got {tuple(x.shape)}")
    return torch.fft.fft2(x, norm="ortho")


def ifft2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D inverse FFT over the last two axes."""
    if x.ndim != 4:
        raise ValueError(f"ifft2 expects [N, C, H, W], got {tuple(x.shape)}")
    return torch.fft.ifft2(x, norm="ortho")


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """Half-roll both spatial axes so corner-DC moves to the center."""
    return torch.roll(x, (x.shape[-2] // 2, x.shape[-1] // 2), dims=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of fftshift2 (handles odd sizes)."""
    return torch.roll(
        x, ((x.shape[-2] + 1) // 2, (x.shape[-1] + 1) // 2), dims=(-2, -1)
    )


def rss(x: torch.Tensor) -> torch.Tensor:
    """Root-sum-of-squares over the coil axis (dim 1), keepdim.

    Real output; an exactly-zero plane maps to 0 through the same guard the
    JAX package uses to keep the gradient at zero finite.
    """
    if x.ndim != 4:
        raise ValueError(f"rss expects [N, C, H, W], got {tuple(x.shape)}")
    mag2 = x.real**2 + x.imag**2 if x.is_complex() else x**2
    s = torch.sum(mag2, dim=1, keepdim=True)
    nonzero = s > 0
    return torch.where(
        nonzero, torch.sqrt(torch.where(nonzero, s, torch.ones_like(s))), 0.0
    )
