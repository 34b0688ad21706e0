"""Parzen-window MI loss, forward and closed-form backward: the CUDA
kernels of `csrc/mi.cu`, their plain PyTorch versions, and the autograd
Function that joins them.

Replaces the Pallas TPU kernels of the JAX package's `ops/pallas/mi.py`:
`_forward` / `_mi_kernel` (pallas_call at :106) and `_backward` /
`_mi_bwd_kernel` (pallas_call at :246), with their custom VJP (:429-446).
Bound on the H100 by f32 operations: see the note at the top of the CUDA
source.

`MILoss.apply(I, J, bins, sigma, minv, maxv)` takes real f32 [N, ...]
tensors of one shape (each sample's M = numel / N pixels form one
histogram) and returns the 0-dim loss: the batch mean of -(H_I + H_J -
H_IJ), with Gaussian (Parzen) responses of every pixel at `bins` centres
b (maxv - minv) / (bins - 1) + minv, as the Pallas kernel places them.
The forward also gives the per-sample statistics (marginal sums and the
joint Gram), which the Function keeps for the backward instead of
recomputing them. Each piece takes the kernel on CUDA tensors and the
plain version on CPU tensors (`kernels.on_card`).
"""

import ctypes
import functools
import math

import torch

from . import check_f32_cuda, check_launch, load, on_card, stream, upstream

FWD = "mi_fwd"
BWD = "mi_bwd"
SOURCE = "mi.cu"
MAX_BINS = 64  # the CUDA kernels' padded bin count
CHUNK = 2048  # pixels a block in the CUDA forward
_PADDED_STATS = 2 * MAX_BINS + MAX_BINS * MAX_BINS


# ------------------------------------------------------------ plain versions
def _parzen(v: torch.Tensor, bins: int, sigma: float, minv: float, maxv: float):
    """Centres [B] and Gaussian responses [N, B, M] of v [N, M], in the
    Pallas kernel's form."""
    centers = (torch.arange(bins, dtype=v.dtype, device=v.device)
               * ((maxv - minv) / (bins - 1)) + minv)
    d = v[:, None, :] - centers[None, :, None]
    p = torch.exp(-(d * d) * (1.0 / (2.0 * sigma * sigma))) / (math.sqrt(2.0 * math.pi) * sigma)
    return centers, p


def _unpack(stats: torch.Tensor, bins: int):
    """stats [N, 2B + B^2] -> s_i [N, B], s_j [N, B], joint [N, B, B]."""
    return (stats[:, :bins], stats[:, bins:2 * bins],
            stats[:, 2 * bins:].reshape(-1, bins, bins))


def _entropy(p: torch.Tensor, dims) -> torch.Tensor:
    return -torch.sum(p * torch.log(p + 1e-10), dim=dims)


def neg_mi(stats: torch.Tensor, m: int, bins: int, sigma: float) -> torch.Tensor:
    """-(H_I + H_J - H_IJ) per sample [N] from the statistics, as the
    epilogue of ops/pallas/mi.py:232-244."""
    s_i, s_j, joint = _unpack(stats, bins)

    def marginal(s):
        p = s / m  # the row mean over the true pixel count
        return _entropy(p / (p.sum(1, keepdim=True) + 1e-10), 1)

    pj = joint / (2.0 * math.pi * sigma * sigma)
    pj = pj / (pj.sum((1, 2), keepdim=True) + 1e-10)
    return -(marginal(s_i) + marginal(s_j) - _entropy(pj, (1, 2)))


def mi_fwd_plain(I: torch.Tensor, J: torch.Tensor, bins: int = 64,
                 sigma: float = 1.0 / 64, minv: float = 0.0, maxv: float = 1.0):
    """(loss, stats): the 0-dim loss and the per-sample statistics [N, 2B +
    B^2] (marginal sums s_i, s_j, then the joint Gram row by row), from the
    dense responses and p_I @ p_J^T."""
    n = I.shape[0]
    vi, vj = I.reshape(n, -1), J.reshape(n, -1)
    _, p_i = _parzen(vi, bins, sigma, minv, maxv)
    _, p_j = _parzen(vj, bins, sigma, minv, maxv)
    joint = p_i @ p_j.transpose(1, 2)
    stats = torch.cat([p_i.sum(2), p_j.sum(2), joint.reshape(n, -1)], 1)
    return neg_mi(stats, vi.shape[1], bins, sigma).mean(), stats


def dloss_dresponses(stats: torch.Tensor, p_i: torch.Tensor, p_j: torch.Tensor,
                     m: int, bins: int, sigma: float):
    """dL/dp_I and dL/dp_J [N, B, M] of the per-sample -MI, from the
    statistics (ops/pallas/mi.py:333-375): the entropy weights w of the
    marginals and the joint coefficients EQ, then
    dL/dp_I = -w_I/m + (EQ p_J)/norm2d, dL/dp_J = -w_J/m + (EQ^T p_I)/norm2d."""
    s_i, s_j, joint = _unpack(stats, bins)

    def marg_w(s):  # d(ent)/d(s_b) = w_b / m for pn = (s / m) / T
        u = s / m
        T = u.sum(1, keepdim=True) + 1e-10
        pn = u / T
        lc = torch.log(pn + 1e-10) + pn / (pn + 1e-10)
        return -(lc - (lc * pn).sum(1, keepdim=True)) / T

    norm2d = 2.0 * math.pi * sigma * sigma
    G = joint / norm2d
    Sg = G.sum((1, 2), keepdim=True) + 1e-10
    q = G / Sg
    lq = torch.log(q + 1e-10) + q / (q + 1e-10)
    EQ = -(lq - (lq * q).sum((1, 2), keepdim=True)) / Sg  # [N, B, B]
    return ((-marg_w(s_i) / m)[:, :, None] + (EQ @ p_j) / norm2d,
            (-marg_w(s_j) / m)[:, :, None] + (EQ.transpose(1, 2) @ p_i) / norm2d)


def mi_bwd_plain(I: torch.Tensor, J: torch.Tensor, stats: torch.Tensor,
                 gout: torch.Tensor, bins: int = 64, sigma: float = 1.0 / 64,
                 minv: float = 0.0, maxv: float = 1.0):
    """(dI, dJ) of the loss for its upstream gradient gout (0-dim), in the
    closed form of ops/pallas/mi.py:333-384: per pixel
    dv = sum_b dL/dp_b p_b (c_b - v) / sigma^2, subtracting before the sum
    over bins (the sum_b A_b c_b - v sum_b A_b form cancels)."""
    n = I.shape[0]
    vi, vj = I.reshape(n, -1), J.reshape(n, -1)
    centers, p_i = _parzen(vi, bins, sigma, minv, maxv)
    _, p_j = _parzen(vj, bins, sigma, minv, maxv)
    dLdp_i, dLdp_j = dloss_dresponses(stats, p_i, p_j, vi.shape[1], bins, sigma)
    inv_sigma2 = 1.0 / (sigma * sigma)

    def pixel_grad(dLdp, p, v):
        return ((dLdp * p) * (centers[None, :, None] - v[:, None, :])).sum(1) * inv_sigma2

    scale = gout.to(I.dtype) / n
    return (scale * pixel_grad(dLdp_i, p_i, vi)).reshape(I.shape), \
        (scale * pixel_grad(dLdp_j, p_j, vj)).reshape(J.shape)


# ------------------------------------------------------------ CUDA wrappers
def check(I: torch.Tensor, J: torch.Tensor, bins: int):
    """Raise on what neither route takes."""
    if I.ndim < 2 or I.shape != J.shape or I.numel() == 0:
        raise ValueError(f"mi expects two non-empty [N, ...] tensors of one "
                         f"shape, got {tuple(I.shape)} and {tuple(J.shape)}")
    if not (isinstance(bins, int) and 2 <= bins <= MAX_BINS):
        raise ValueError(f"mi takes 2 to {MAX_BINS} bins, got {bins!r}")
    if I.device != J.device:
        raise ValueError(f"I on {I.device}, J on {J.device}")


def _check_cuda(*tensors: torch.Tensor):
    check_f32_cuda("mi", *tensors)
    n = tensors[0].shape[0]
    if tensors[0].numel() >= 2**31 or n > 65535:
        raise ValueError("mi kernels take fewer than 2^31 elements and at most "
                         "65535 samples")


def _parzen_args(bins, sigma, minv, maxv):
    """The floats the kernels take: min, centre step, 1 / (2 sigma^2),
    the 1-D and 2-D normalisers (and the backward also 1 / sigma^2)."""
    return [minv, (maxv - minv) / (bins - 1), 1.0 / (2.0 * sigma * sigma),
            math.sqrt(2.0 * math.pi) * sigma, 2.0 * math.pi * sigma * sigma]


def mi_fwd_cuda(I: torch.Tensor, J: torch.Tensor, bins: int = 64,
                sigma: float = 1.0 / 64, minv: float = 0.0, maxv: float = 1.0):
    """Launch the forward kernels; (loss, stats) as `mi_fwd_plain`."""
    check(I, J, bins)
    _check_cuda(I, J)
    n = I.shape[0]
    m = I.numel() // n
    chunks = -(-m // CHUNK)
    dev = I.device
    partial = torch.empty(n * chunks * _PADDED_STATS, dtype=torch.float32, device=dev)
    stats = torch.empty((n, 2 * bins + bins * bins), dtype=torch.float32, device=dev)
    per = torch.empty(n, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    rc = _launcher("san_mi_fwd")(
        I.data_ptr(), J.data_ptr(), partial.data_ptr(), stats.data_ptr(),
        per.data_ptr(), loss.data_ptr(), n, m, bins,
        *_parzen_args(bins, sigma, minv, maxv), stream(I),
    )
    check_launch(FWD, rc)
    return loss, stats


def mi_bwd_cuda(I: torch.Tensor, J: torch.Tensor, stats: torch.Tensor,
                gout: torch.Tensor, bins: int = 64, sigma: float = 1.0 / 64,
                minv: float = 0.0, maxv: float = 1.0):
    """Launch the backward kernels; (dI, dJ) for the upstream gradient gout
    (a 0-dim f32 tensor on the same card) and the forward's stats."""
    check(I, J, bins)
    _check_cuda(I, J, stats)
    n = I.shape[0]
    if stats.shape != (n, 2 * bins + bins * bins) or stats.device != I.device:
        raise ValueError(f"stats must be [{n}, {2 * bins + bins * bins}] on I's "
                         f"device, got {tuple(stats.shape)} on {stats.device}")
    g = upstream("mi", gout, I)
    m = I.numel() // n
    coef = torch.empty(n * _PADDED_STATS, dtype=torch.float32, device=I.device)
    dI = torch.empty_like(I)
    dJ = torch.empty_like(J)
    rc = _launcher("san_mi_bwd")(
        I.data_ptr(), J.data_ptr(), stats.data_ptr(), coef.data_ptr(),
        g.data_ptr(), dI.data_ptr(), dJ.data_ptr(), n, m, bins,
        *_parzen_args(bins, sigma, minv, maxv), 1.0 / (sigma * sigma), stream(I),
    )
    check_launch(BWD, rc)
    return dI, dJ


_SIZES = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]  # n, m, bins
_ARGTYPES = {
    "san_mi_fwd": [ctypes.c_void_p] * 6 + _SIZES + [ctypes.c_float] * 5
    + [ctypes.c_void_p],
    "san_mi_bwd": [ctypes.c_void_p] * 7 + _SIZES + [ctypes.c_float] * 6
    + [ctypes.c_void_p],
}


@functools.cache
def _launcher(symbol: str):
    fn = getattr(load(SOURCE), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ autograd
class MILoss(torch.autograd.Function):
    """Batch-mean negative MI with the closed-form backward of the JAX
    package's Pallas kernel: kernels on CUDA tensors, plain versions on CPU
    tensors. The forward's statistics are kept for the backward."""

    @staticmethod
    def forward(ctx, I, J, bins, sigma, minv, maxv):
        check(I, J, bins)
        ctx.parzen = (bins, sigma, minv, maxv)
        fwd = mi_fwd_cuda if on_card(I) else mi_fwd_plain
        loss, stats = fwd(I, J, bins, sigma, minv, maxv)
        ctx.save_for_backward(I, J, stats)
        return loss

    @staticmethod
    def backward(ctx, gout):
        I, J, stats = ctx.saved_tensors
        bwd = mi_bwd_cuda if on_card(I) else mi_bwd_plain
        dI, dJ = bwd(I, J, stats, gout, *ctx.parzen)
        return (dI if ctx.needs_input_grad[0] else None,
                dJ if ctx.needs_input_grad[1] else None, None, None, None, None)
