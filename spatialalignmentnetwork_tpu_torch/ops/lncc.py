"""Local normalized cross-correlation registration loss (counterpart of the
JAX package's `ops/lncc.py`).

The reference library loss (lnccloss.py:7-65): win x win zero-padded SAME
windows, cc = cross^2 / (I_var * J_var + 1e-5), loss = -mean(cc); the
multi-scale variant smooths with a Gaussian and 2x average-pools between
scales. `lncc_loss` goes through the autograd Function of
`kernels/lncc.py`: the CUDA kernels forward and backward on CUDA tensors,
their plain versions on CPU tensors.
"""

import torch

from ..kernels import lncc as klncc
from ..kernels import on_card
from .mi import gaussian_smooth
from .window import avg_pool2d_nchw


def compute_local_sums(I: torch.Tensor, J: torch.Tensor, win: int):
    """(I_var, J_var, cross) over SAME win x win windows, in plain torch."""
    return klncc.local_sums(I, J, win)


def lncc_loss(I: torch.Tensor, J: torch.Tensor, win: int = 9) -> torch.Tensor:
    """-mean(cc) of real f32 [N, C, H, W] tensors (a 0-dim tensor),
    differentiable in both."""
    klncc.check(I, J, win)
    on_card(I)  # any other device raises here, before autograd records
    return klncc.LNCCLoss.apply(I.contiguous(), J.contiguous(), win)


def ms_lncc_loss(I: torch.Tensor, J: torch.Tensor, win: int = 9, ms: int = 3,
                 sigma: float = 3.0) -> torch.Tensor:
    """The mean of `lncc_loss` over `ms` scales, each the last one
    Gaussian-smoothed and 2x average-pooled."""
    loss = lncc_loss(I, J, win)
    for _ in range(ms - 1):
        I = avg_pool2d_nchw(gaussian_smooth(I, sigma))
        J = avg_pool2d_nchw(gaussian_smooth(J, sigma))
        loss = loss + lncc_loss(I, J, win)
    return loss / ms
