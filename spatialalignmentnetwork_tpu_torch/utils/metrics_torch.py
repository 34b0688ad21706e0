"""Evaluation metrics on tensors of any device (counterpart of the JAX
package's `utils/metrics_jax.py`).

The eval step computes its scalars where its images are, so that only
scalars cross to the host. Each function takes real [N, C, H, W] tensors
and has the semantics of its JAX counterpart: whole-batch forms return a
0-dim tensor, the `*_per_slice` forms one value a slice, [N], which the
bucketed eval step weights to leave pad slices out.

  * ssim goes through `ops/ssim.py::ssim_per_plane`: one launch of the
    SSIM forward kernel on a card (its plain version on the CPU), whose
    per-plane sums over the VALID 7x7 windows give each slice's mean
    (data range 1, the kernel's constants).
  * mi is the hard 64-bin joint histogram of the JAX package (not the
    Parzen MI loss): JAX's binning floor((x - minv) * scale) in f32,
    clipped to [0, bins - 1], the validity mask closed on the right (as
    np.histogram2d), counts by `index_add_` (whole counts, exact in f32 in
    any order). Counts, normalisation and sums are in f32 as in JAX, and in
    float64 for float64 inputs, so that a float64 reference is one.
"""

import torch

from ..ops.ssim import ssim_per_plane

_SLICE = (1, 2, 3)


def mse(gt, pred):
    return torch.mean((gt - pred) ** 2)


def mae(gt, pred):
    return torch.mean(torch.abs(gt - pred))


def nmse(gt, pred):
    return torch.sum((gt - pred) ** 2) / torch.sum(gt**2)


def psnr(gt, pred, data_range=1.0):
    return 10.0 * torch.log10((data_range**2) / mse(gt, pred))


def ssim(gt, pred):
    """Valid-window SSIM averaged over the batch."""
    return torch.mean(ssim_per_slice(gt, pred))


def mi(gt, pred, bins=64, minVal=0.0, maxVal=1.0):
    """Batch-averaged per-slice mutual information."""
    return torch.mean(mi_per_slice(gt, pred, bins, minVal, maxVal))


# ------------------------------------------------ per-slice reductions
def mse_per_slice(gt, pred):
    return torch.mean((gt - pred) ** 2, dim=_SLICE)


def mae_per_slice(gt, pred):
    return torch.mean(torch.abs(gt - pred), dim=_SLICE)


def nmse_per_slice(gt, pred):
    return torch.sum((gt - pred) ** 2, dim=_SLICE) / torch.sum(gt**2, dim=_SLICE)


def psnr_per_slice(gt, pred, data_range=1.0):
    return 10.0 * torch.log10((data_range**2) / mse_per_slice(gt, pred))


def ssim_per_slice(gt, pred):
    return torch.mean(ssim_per_plane(gt, pred), dim=1)


def _hist2d_64(x, y, bins=64, minv=0.0, maxv=1.0):
    """Joint histograms [..., bins, bins] of x and y [..., P] (one a
    leading index), np.histogram2d's semantics: values in [minv, maxv],
    the right edge closed. Values outside the range, NaN included, count
    nowhere. Counts in float64 for float64 inputs, f32 otherwise."""
    scale = bins / (maxv - minv)
    valid = (x >= minv) & (x <= maxv) & (y >= minv) & (y <= maxv)

    def index(v):
        # out-of-range values index bin 0 with weight 0: a NaN's integer
        # conversion is undefined
        v = torch.where(valid, v, minv)
        return torch.clamp(torch.floor((v - minv) * scale), 0, bins - 1).to(torch.int64)

    lead = x.shape[:-1]
    flat = index(x) * bins + index(y)
    offset = torch.arange(flat[..., 0].numel(), device=x.device).reshape(lead) * (bins * bins)
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    counts = torch.zeros(flat[..., 0].numel() * bins * bins, dtype=dtype, device=x.device)
    counts.index_add_(0, (flat + offset[..., None]).reshape(-1), valid.to(dtype).reshape(-1))
    return counts.reshape(*lead, bins, bins)


def _xlogy(x, y):
    """x log y, 0 where x is 0 (whatever y is)."""
    zero = x == 0.0
    return torch.where(zero, 0.0, x * torch.log(torch.where(zero, 1.0, y)))


def mi_per_slice(gt, pred, bins=64, minVal=0.0, maxVal=1.0):
    """Per-slice 64-bin joint-histogram mutual information -> [N] (the
    reference's metrics.py:55-69)."""
    n = gt.shape[0]
    pxy = _hist2d_64(gt.reshape(n, -1), pred.reshape(n, -1), bins, minVal, maxVal)
    pxy = pxy / (pxy.sum(dim=(1, 2), keepdim=True) + 1e-10)
    px = pxy.sum(dim=2)
    py = pxy.sum(dim=1)
    pxpy = px[:, :, None] * py[:, None, :]
    return (_xlogy(pxy, pxy) - _xlogy(pxy, pxpy)).sum(dim=(1, 2))
