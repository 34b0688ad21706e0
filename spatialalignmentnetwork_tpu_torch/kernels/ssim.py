"""SSIM loss, forward and closed-form backward: the CUDA kernels of
`csrc/ssim.cu`, their plain PyTorch versions, and the autograd Function
that joins them.

Replaces the Pallas TPU kernels of the JAX package's `ops/pallas/ssim.py`:
`_forward` / `_ssim_sum_kernel` (pallas_call at :81) and `_backward` /
`_ssim_bwd_kernel` (pallas_call at :204), with their custom VJP
(:224-247). Bound on the H100 by memory: see the note at the top of the
CUDA source.

`SSIMLoss.apply(X, Y)` takes real f32 [N, C, H, W] tensors (H, W >= 7)
and returns the 0-dim loss 1 - mean(S) over the 7x7 VALID windows. Each
piece takes the kernel on CUDA tensors and the plain version on CPU
tensors (`kernels.on_card`).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops.window import window_sum2d
from . import check_f32_cuda, check_launch, load, on_card, stream, upstream

FWD = "ssim_fwd"
BWD = "ssim_bwd"
SOURCE = "ssim.cu"
WIN = 7
TILE = 32  # outputs per tile side in the CUDA kernels


# ------------------------------------------------------------ plain versions
def ssim_terms(X: torch.Tensor, Y: torch.Tensor, win: int = WIN,
               k1: float = 0.01, k2: float = 0.03,
               data_range: float = 1.0) -> dict:
    """The window means and SSIM terms of the JAX package's
    ops/ssim.py:19-40 over VALID windows: ux, uy, A1, A2, B1, B2, S."""
    NP = win * win
    cov_norm = NP / (NP - 1)
    C1 = (k1 * data_range) ** 2
    C2 = (k2 * data_range) ** 2
    inv = 1.0 / NP
    ux = window_sum2d(X, win) * inv
    uy = window_sum2d(Y, win) * inv
    uxx = window_sum2d(X * X, win) * inv
    uyy = window_sum2d(Y * Y, win) * inv
    uxy = window_sum2d(X * Y, win) * inv
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    return {"ux": ux, "uy": uy, "A1": A1, "A2": A2, "B1": B1, "B2": B2,
            "S": (A1 * A2) / (B1 * B2)}


def ssim_fwd_plain(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Per-plane sums of the SSIM map, [N, C] f32."""
    return ssim_terms(X, Y)["S"].sum(dim=(2, 3))


def ssim_bwd_plain(X: torch.Tensor, Y: torch.Tensor, gout: torch.Tensor):
    """(dX, dY) of the loss for its upstream gradient gout (0-dim), in the
    closed form of ops/pallas/ssim.py:138-193: per-window coefficients
    G_q = dS/du_q, scattered back over the pixels by the transposed window
    sum (a VALID window sum of the G maps zero-padded by win - 1)."""
    n, c, h, w = X.shape
    t = ssim_terms(X, Y)
    NP = WIN * WIN
    cn = NP / (NP - 1)
    ux, uy = t["ux"], t["uy"]
    D = t["B1"] * t["B2"]
    S = t["S"]
    sA1 = t["A2"] / D
    sA2 = t["A1"] / D
    sB1 = -S / t["B1"]
    sB2 = -S / t["B2"]
    G_ux = (sA1 * (2 * uy) + sA2 * (-2 * cn * uy)
            + sB1 * (2 * ux) + sB2 * (-2 * cn * ux))
    G_uy = (sA1 * (2 * ux) + sA2 * (-2 * cn * ux)
            + sB1 * (2 * uy) + sB2 * (-2 * cn * uy))
    G_uxy = sA2 * (2 * cn)
    G_uvv = sB2 * cn  # dS/duxx == dS/duyy

    def box(g):  # transposed window sum
        return window_sum2d(F.pad(g, (WIN - 1,) * 4), WIN)

    b_ux, b_uy, b_xy, b_vv = box(G_ux), box(G_uy), box(G_uxy), box(G_uvv)
    valid = (h - WIN + 1) * (w - WIN + 1)
    scale = 1.0 / (n * c * valid * NP)
    g = gout.to(torch.float32)
    dX = g * ((-scale) * (b_ux + 2.0 * X * b_vv + Y * b_xy))
    dY = g * ((-scale) * (b_uy + 2.0 * Y * b_vv + X * b_xy))
    return dX, dY


# ------------------------------------------------------------ CUDA wrappers
def _check(X: torch.Tensor, Y: torch.Tensor):
    if X.ndim != 4 or X.shape != Y.shape:
        raise ValueError(f"ssim expects two [N, C, H, W] tensors of one shape, "
                         f"got {tuple(X.shape)} and {tuple(Y.shape)}")
    if X.shape[2] < WIN or X.shape[3] < WIN:
        raise ValueError(f"ssim needs planes of at least {WIN}x{WIN}, got "
                         f"{tuple(X.shape[2:])}")
    if X.device != Y.device:
        raise ValueError(f"X on {X.device}, Y on {Y.device}")


def _check_cuda(*tensors: torch.Tensor):
    check_f32_cuda("ssim", *tensors)
    n, c, h, w = tensors[0].shape
    if n * c * h * w >= 2**31 or 4 * n * c * (h - WIN + 1) * (w - WIN + 1) >= 2**31:
        raise ValueError("ssim kernels take fewer than 2^31 elements")
    if n * c > 65535:
        raise ValueError("ssim kernels take at most 65535 planes")


def _tiles(h: int, w: int) -> int:
    return -(-(h - WIN + 1) // TILE) * -(-(w - WIN + 1) // TILE)


def ssim_fwd_cuda(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernels; per-plane sums of the SSIM map [N, C]."""
    _check(X, Y)
    _check_cuda(X, Y)
    n, c, h, w = X.shape
    partial = torch.empty(n * c * _tiles(h, w), dtype=torch.float32, device=X.device)
    sums = torch.empty((n, c), dtype=torch.float32, device=X.device)
    rc = _launcher("san_ssim_fwd")(
        X.data_ptr(), Y.data_ptr(), partial.data_ptr(), sums.data_ptr(),
        n * c, h, w, stream(X),
    )
    check_launch(FWD, rc)
    return sums


def ssim_bwd_cuda(X: torch.Tensor, Y: torch.Tensor, gout: torch.Tensor):
    """Launch the backward kernels; (dX, dY) for the upstream gradient gout
    (a 0-dim f32 tensor on the same card)."""
    _check(X, Y)
    _check_cuda(X, Y)
    g = upstream("ssim", gout, X)
    n, c, h, w = X.shape
    coef = torch.empty(4 * n * c * (h - WIN + 1) * (w - WIN + 1),
                       dtype=torch.float32, device=X.device)
    dX = torch.empty_like(X)
    dY = torch.empty_like(Y)
    valid = (h - WIN + 1) * (w - WIN + 1)
    rc = _launcher("san_ssim_bwd")(
        X.data_ptr(), Y.data_ptr(), coef.data_ptr(), g.data_ptr(),
        1.0 / (n * c * valid * WIN * WIN), dX.data_ptr(), dY.data_ptr(),
        n * c, h, w, stream(X),
    )
    check_launch(BWD, rc)
    return dX, dY


_ARGTYPES = {
    "san_ssim_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p],
    "san_ssim_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_float]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p],
}


@functools.cache
def _launcher(symbol: str):
    fn = getattr(load(SOURCE), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ autograd
class SSIMLoss(torch.autograd.Function):
    """1 - mean SSIM with the closed-form backward of the JAX package's
    Pallas kernel: kernels on CUDA tensors, plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, X, Y):
        _check(X, Y)
        ctx.save_for_backward(X, Y)
        n, c, h, w = X.shape
        fwd = ssim_fwd_cuda if on_card(X) else ssim_fwd_plain
        sums = fwd(X, Y)
        return 1.0 - sums.sum() / (n * c * (h - WIN + 1) * (w - WIN + 1))

    @staticmethod
    def backward(ctx, gout):
        X, Y = ctx.saved_tensors
        bwd = ssim_bwd_cuda if on_card(X) else ssim_bwd_plain
        dX, dY = bwd(X, Y, gout)
        return (dX if ctx.needs_input_grad[0] else None,
                dY if ctx.needs_input_grad[1] else None)
