"""Host-side evaluation metrics in numpy (the port's own copy of the JAX
package's `utils/metrics.py`), with the semantics of the reference's
metrics.py:23-69, which uses skimage and scipy:

  * psnr: over the whole [N, 1, H, W] volume, data_range 1.
  * ssim: per-slice skimage-style structural similarity (7x7 uniform
    window, K1 0.01, K2 0.03, data_range 1, the mean over the windows
    that lie inside the image), averaged over the slices.
  * mi: 64-bin joint-histogram mutual information a slice, averaged.
  * mse, mae, nmse, dice: direct formulas.

skimage is not needed: ssim is the same valid-window uniform-filter
formula that skimage computes, in float64.
"""

import numpy as np
from scipy.ndimage import uniform_filter
from scipy.special import xlogy


def to_numpy(*args):
    out = []
    for a in args:
        a = np.asarray(a)
        if a.ndim != 4:
            raise ValueError(f"expected [batch, channel, rows, cols], got {a.shape}")
        out.append(a)
    return out


def mse(gt, pred):
    gt, pred = to_numpy(gt, pred)
    return float(np.mean((gt - pred) ** 2))


def mae(gt, pred):
    gt, pred = to_numpy(gt, pred)
    return float(np.mean(np.abs(gt - pred)))


def nmse(gt, pred):
    gt, pred = to_numpy(gt, pred)
    return float(np.linalg.norm(gt - pred) ** 2 / np.linalg.norm(gt) ** 2)


def psnr(gt, pred, data_range=1.0):
    gt, pred = to_numpy(gt, pred)
    err = np.mean((gt - pred) ** 2, dtype=np.float64)
    return float(10 * np.log10((data_range**2) / err))


def _ssim_2d(x, y, data_range=1.0, win_size=7, k1=0.01, k2=0.03):
    """skimage's structural_similarity for one 2-D image pair."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    NP = win_size**2
    cov_norm = NP / (NP - 1)

    def filt(a):
        return uniform_filter(a, size=win_size)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (k1 * data_range) ** 2
    C2 = (k2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux**2 + uy**2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def ssim(gt, pred, data_range=1.0):
    gt, pred = to_numpy(gt, pred)
    return float(
        np.mean([_ssim_2d(g[0], p[0], data_range) for g, p in zip(gt, pred)])
    )


def dice(gt, pred, label=None):
    """Sørensen–Dice overlap 2|A∩B| / (|A|+|B|) of two label maps (the
    reference's metrics.py:45-52). Two empty masks overlap perfectly: the
    formula's 0/0 is taken as 1."""
    gt, pred = to_numpy(gt, pred)
    a = gt.astype(bool) if label is None else np.equal(gt, label)
    b = pred.astype(bool) if label is None else np.equal(pred, label)
    hits = np.count_nonzero(a & b)
    denom = np.count_nonzero(a) + np.count_nonzero(b)
    if denom == 0:
        return 1.0
    return float(2.0 * hits / denom)


def _entropy(p):
    """Shannon entropy of a histogram normalised up to its +1e-10."""
    return -float(xlogy(p, p).sum())


def mi(gt, pred, bins=64, minVal=0, maxVal=1):
    """Per-slice mutual information from a 64-bin joint histogram over
    [minVal, maxVal]², averaged over the batch, as H(x) + H(y) - H(x, y):
    the same quantity as the reference's sum p log p - sum p log(px py)
    (metrics.py:55-69), with its range-clipped histogram and its +1e-10
    normalisation."""
    gt, pred = to_numpy(gt, pred)
    if gt.shape != pred.shape:
        raise ValueError(f"shapes differ: {gt.shape} and {pred.shape}")
    span = (minVal, maxVal)
    vals = []
    for x, y in zip(gt, pred):
        joint = np.histogram2d(
            x.ravel(), y.ravel(), bins, range=(span, span)
        )[0]
        joint /= joint.sum() + 1e-10
        vals.append(
            _entropy(joint.sum(axis=0))
            + _entropy(joint.sum(axis=1))
            - _entropy(joint)
        )
    return float(np.mean(vals))
