"""LNCC loss, forward and closed-form backward: the CUDA kernels of
`csrc/lncc.cu`, their plain PyTorch versions, and the autograd Function
that joins them.

Replaces the Pallas TPU kernels of the JAX package's `ops/pallas/lncc.py`:
`_forward` / `_lncc_sum_kernel` (pallas_call at :57) and `_backward` /
`_lncc_bwd_kernel` (pallas_call at :117), with their custom VJP
(:137-153). Bound on the H100 by memory: see the note at the top of the
CUDA source.

`LNCCLoss.apply(I, J, win)` takes real f32 [N, C, H, W] tensors and an odd
window of at most MAX_WIN and returns the 0-dim loss -mean(cc) over the
win x win SAME (zero-padded) windows, cc = cross^2 / (I_var J_var + 1e-5).
Each piece takes the kernel on CUDA tensors and the plain version on CPU
tensors (`kernels.on_card`).
"""

import ctypes
import functools

import torch

from ..ops.window import window_sum2d
from . import check_f32_cuda, fwd_rows, fwd_tiles, launch, load, on_card, upstream

FWD = "lncc_fwd"
BWD = "lncc_bwd"
SOURCE = "lncc.cu"
MAX_WIN = 15  # the CUDA kernels' halo is sized for it
TILE = 32  # outputs per tile side in the CUDA backward
EPS = 1e-5


# ------------------------------------------------------------ plain versions
def local_sums(I: torch.Tensor, J: torch.Tensor, win: int):
    """(I_var, J_var, cross) over SAME windows, in the expanded formula of
    the JAX package's ops/lncc.py:17-31 (and its Pallas forward)."""
    I_sum = window_sum2d(I, win, "SAME")
    J_sum = window_sum2d(J, win, "SAME")
    I2_sum = window_sum2d(I * I, win, "SAME")
    J2_sum = window_sum2d(J * J, win, "SAME")
    IJ_sum = window_sum2d(I * J, win, "SAME")
    ws = win * win
    u_I = I_sum / ws
    u_J = J_sum / ws
    cross = IJ_sum - u_J * I_sum - u_I * J_sum + u_I * u_J * ws
    I_var = I2_sum - 2 * u_I * I_sum + u_I * u_I * ws
    J_var = J2_sum - 2 * u_J * J_sum + u_J * u_J * ws
    return I_var, J_var, cross


def lncc_fwd_plain(I: torch.Tensor, J: torch.Tensor, win: int = 9) -> torch.Tensor:
    """Per-plane sums of the cc map, [N, C]."""
    I_var, J_var, cross = local_sums(I, J, win)
    cc = cross * cross / (I_var * J_var + EPS)
    return cc.sum(dim=(2, 3))


def lncc_bwd_plain(I: torch.Tensor, J: torch.Tensor, gout: torch.Tensor,
                   win: int = 9):
    """(dI, dJ) of the loss for its upstream gradient gout (0-dim), in the
    closed form of ops/pallas/lncc.py:80-110: per-centre coefficients
    d(cc)/d(window sum), scattered back over the pixels by the same SAME
    window sum (self-adjoint for odd win)."""
    n, c, h, w = I.shape
    ws = win * win
    I_sum = window_sum2d(I, win, "SAME")
    J_sum = window_sum2d(J, win, "SAME")
    I2_sum = window_sum2d(I * I, win, "SAME")
    J2_sum = window_sum2d(J * J, win, "SAME")
    IJ_sum = window_sum2d(I * J, win, "SAME")
    cross = IJ_sum - I_sum * J_sum / ws
    I_var = I2_sum - I_sum * I_sum / ws
    J_var = J2_sum - J_sum * J_sum / ws
    D = I_var * J_var + EPS
    Pc = 2.0 * cross / D  # d(cc)/d(cross)
    cc_over_D = (cross * cross) / (D * D)
    Pv_I = -cc_over_D * J_var  # d(cc)/d(I_var)
    Pv_J = -cc_over_D * I_var
    G_Is = Pc * (-J_sum / ws) + Pv_I * (-2.0 * I_sum / ws)
    G_Js = Pc * (-I_sum / ws) + Pv_J * (-2.0 * J_sum / ws)
    b_Is, b_Js, b_I2, b_J2, b_IJ = (window_sum2d(g, win, "SAME")
                                    for g in (G_Is, G_Js, Pv_I, Pv_J, Pc))
    s = gout.to(I.dtype) * (-1.0 / (n * c * h * w))
    dI = s * (b_Is + 2.0 * I * b_I2 + J * b_IJ)
    dJ = s * (b_Js + 2.0 * J * b_J2 + I * b_IJ)
    return dI, dJ


# ------------------------------------------------------------ CUDA wrappers
def check(I: torch.Tensor, J: torch.Tensor, win: int):
    """Raise on what neither route takes."""
    if I.ndim != 4 or I.shape != J.shape:
        raise ValueError(f"lncc expects two [N, C, H, W] tensors of one shape, "
                         f"got {tuple(I.shape)} and {tuple(J.shape)}")
    if not (isinstance(win, int) and win % 2 == 1 and 1 <= win <= MAX_WIN):
        raise ValueError(f"lncc takes an odd window of 1 to {MAX_WIN}, got {win!r}")
    if I.device != J.device:
        raise ValueError(f"I on {I.device}, J on {J.device}")


def _check_cuda(*tensors: torch.Tensor):
    check_f32_cuda("lncc", *tensors)
    n, c, h, w = tensors[0].shape
    if n * c * h * w >= 2**31:
        raise ValueError("lncc kernels take fewer than 2^31 elements")
    if n * c > 65535:
        raise ValueError("lncc kernels take at most 65535 planes")


def lncc_fwd_cuda(I: torch.Tensor, J: torch.Tensor, win: int = 9) -> torch.Tensor:
    """Launch the forward kernel; per-plane sums of the cc map [N, C]. Its
    tile's rows come from `kernels.fwd_rows`, which sizes the partials'
    scratch too: one a tile."""
    check(I, J, win)
    _check_cuda(I, J)
    n, c, h, w = I.shape
    rows = fwd_rows(n * c, h, w, torch.cuda.get_device_properties(I.device).multi_processor_count)
    partial = torch.empty(n * c * fwd_tiles(h, w, rows), dtype=torch.float32,
                          device=I.device)
    sums = torch.empty((n, c), dtype=torch.float32, device=I.device)
    launch(FWD, _launcher("san_lncc_fwd"), I,
           I.data_ptr(), J.data_ptr(), partial.data_ptr(), sums.data_ptr(),
           n * c, h, w, win, rows)
    return sums


def lncc_bwd_cuda(I: torch.Tensor, J: torch.Tensor, gout: torch.Tensor,
                  win: int = 9):
    """Launch the fused backward kernel; (dI, dJ) for the upstream gradient
    gout (a 0-dim f32 tensor on the same card). No scratch: the
    coefficient maps stay in each block's shared memory."""
    check(I, J, win)
    _check_cuda(I, J)
    g = upstream("lncc", gout, I)
    n, c, h, w = I.shape
    dI = torch.empty_like(I)
    dJ = torch.empty_like(J)
    launch(BWD, _launcher("san_lncc_bwd"), I,
           I.data_ptr(), J.data_ptr(), g.data_ptr(), 1.0 / (n * c * h * w),
           dI.data_ptr(), dJ.data_ptr(), n * c, h, w, win)
    return dI, dJ


_ARGTYPES = {
    "san_lncc_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "san_lncc_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_float]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


@functools.cache
def _launcher(symbol: str):
    fn = getattr(load(SOURCE), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ autograd
class LNCCLoss(torch.autograd.Function):
    """-mean(cc) with the closed-form backward of the JAX package's Pallas
    kernel: kernels on CUDA tensors, plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, I, J, win):
        check(I, J, win)
        ctx.win = win
        ctx.save_for_backward(I, J)
        n, c, h, w = I.shape
        fwd = lncc_fwd_cuda if on_card(I) else lncc_fwd_plain
        return -fwd(I, J, win).sum() / (n * c * h * w)

    @staticmethod
    def backward(ctx, gout):
        I, J = ctx.saved_tensors
        bwd = lncc_bwd_cuda if on_card(I) else lncc_bwd_plain
        dI, dJ = bwd(I, J, gout, ctx.win)
        return (dI if ctx.needs_input_grad[0] else None,
                dJ if ctx.needs_input_grad[1] else None, None)
