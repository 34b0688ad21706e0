"""Differentiable mutual-information registration loss with Parzen windows,
and the Gaussian smoothing of the multi-scale losses (counterpart of the
JAX package's `ops/mi.py`).

The reference library loss (miloss.py): marginal densities from Gaussian
responses at `bins` centres (sigma 1/64 of the intensity range), the joint
density as the Gram of the per-pixel responses; the batch is averaged.
`mi_loss` goes through the autograd Function of `kernels/mi.py`: the CUDA
kernels forward and backward on CUDA tensors, their plain versions on CPU
tensors. Its centres are the Pallas kernel's, b (maxVal - minVal) /
(bins - 1) + minVal.
"""

import math

import torch

from ..kernels import mi as kmi
from ..kernels import on_card
from .window import avg_pool2d_nchw, conv2d_same_nchw


def gaussian_kernel_1d(sigma: float) -> torch.Tensor:
    """Normalised 1-D Gaussian of 2 ceil(2 sigma) + 1 taps (f32, CPU)."""
    kernel_size = int(2 * math.ceil(sigma * 2) + 1)
    half = (kernel_size - 1) // 2
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float32)
    k = (1.0 / (sigma * math.sqrt(2 * math.pi))) * torch.exp(-(x**2) / (2 * sigma**2))
    return k / torch.sum(k)


def gaussian_kernel_2d(sigma_hw) -> torch.Tensor:
    """Normalised outer product of two 1-D Gaussians (sigma_h, sigma_w)."""
    k = torch.outer(gaussian_kernel_1d(sigma_hw[0]), gaussian_kernel_1d(sigma_hw[1]))
    return k / torch.sum(k)


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of [N, C, H, W] with a (2 ceil(2 sigma) + 1)^2 kernel,
    zero-padded."""
    return conv2d_same_nchw(img, gaussian_kernel_2d((sigma, sigma)))


def mi_loss(I: torch.Tensor, J: torch.Tensor, bins: int = 64,
            sigma: float = 1.0 / 64, minVal: float = 0.0,
            maxVal: float = 1.0) -> torch.Tensor:
    """Negative MI between per-sample image pairs [N, ...], averaged over
    the batch (a 0-dim tensor), differentiable in both."""
    kmi.check(I, J, bins)
    on_card(I)  # any other device raises here, before autograd records
    return kmi.MILoss.apply(I.contiguous(), J.contiguous(), bins, sigma,
                            minVal, maxVal)


def ms_mi_loss(I: torch.Tensor, J: torch.Tensor, bins: int = 64,
               sigma: float = 1.0 / 64, ms: int = 3, smooth: float = 3.0,
               minVal: float = 0.0, maxVal: float = 1.0) -> torch.Tensor:
    """The mean of `mi_loss` over `ms` scales, each the last one
    Gaussian-smoothed and 2x average-pooled ([N, C, H, W] inputs)."""
    loss = mi_loss(I, J, bins=bins, sigma=sigma, minVal=minVal, maxVal=maxVal)
    for _ in range(ms - 1):
        I = avg_pool2d_nchw(gaussian_smooth(I, smooth))
        J = avg_pool2d_nchw(gaussian_smooth(J, smooth))
        loss = loss + mi_loss(I, J, bins=bins, sigma=sigma, minVal=minVal,
                              maxVal=maxVal)
    return loss / ms
