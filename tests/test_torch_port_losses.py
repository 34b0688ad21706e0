"""The PyTorch port's registration-loss library against the JAX package, on
the CPU.

The window helpers (`avg_pool2d_nchw`, `conv2d_same_nchw`), the Gaussian
kernels and smoothing, LNCC and MI (forward and gradients, through the
autograd Functions that take the CUDA kernels on a card and their plain
versions here), their multi-scale variants, and warp -> ms loss as a whole.
Each is held against the JAX package's jnp path and, for LNCC and MI, the
Pallas kernel in interpret mode (`tests/test_pallas.py` runs them so).
Inputs come from numpy seeds.

Tolerances:
  * helpers: rtol 1e-6 / atol 1e-6 (f32 rounding order of the
    convolutions);
  * against the jnp path, the JAX package's own bars for the same pair
    (tests/test_pallas.py): LNCC loss 2e-4, MI loss 1e-3, gradients rtol
    1e-3 / atol 1e-5;
  * against the Pallas kernels, whose formulas the port follows: loss rtol
    1e-5, gradients rtol 1e-4 with atol 1e-5 of the gradient's max |value|
    (measured: up to 5e-6 of it). Near-flat LNCC windows, where the
    variances are differences of near-equal sums decided by rounding on
    either route, are held at the jnp bar against both;
  * the closed-form backwards against torch's autograd of the plain
    forwards: as against the Pallas kernels.
"""

import contextlib
import math
import os
import re
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.ops import lncc as jlncc
from spatialalignmentnetwork_tpu.ops import mi as jmi
from spatialalignmentnetwork_tpu.ops import window as jwindow
from spatialalignmentnetwork_tpu.ops.grid_sample import identity_grid as jidentity_grid
from spatialalignmentnetwork_tpu.ops.grid_sample import warp as jwarp
from spatialalignmentnetwork_tpu.ops.pallas.lncc import lncc_loss_pallas
from spatialalignmentnetwork_tpu.ops.pallas.mi import mi_loss_pallas

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc
from spatialalignmentnetwork_tpu_torch.kernels import mi as kmi
from spatialalignmentnetwork_tpu_torch.ops import lncc as tlncc
from spatialalignmentnetwork_tpu_torch.ops import mi as tmi
from spatialalignmentnetwork_tpu_torch.ops import window as twindow
from spatialalignmentnetwork_tpu_torch.ops.grid_sample import warp

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = dict(rtol=1e-6, atol=1e-6)
JNP_LNCC_LOSS = 2e-4
JNP_MI_LOSS = 1e-3
JNP_GRAD = dict(rtol=1e-3, atol=1e-5)
PALLAS_LOSS_RTOL = 1e-5
# rtol, and atol as a fraction of the reference gradient's max |value|
PALLAS_GRAD = dict(rtol=1e-4, atol_of_max=1e-5)
CLOSED_FORM = dict(rtol=1e-4, atol_of_max=1e-5)


def _jax_value_and_grad(fn, a, b):
    loss, grads = jax.value_and_grad(fn, (0, 1))(jnp.asarray(a), jnp.asarray(b))
    return float(loss), [np.asarray(g) for g in grads]


def _torch_value_and_grad(fn, a, b):
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    loss = fn(ta, tb)
    assert loss.shape == ()
    loss.backward()
    return float(loss.detach()), [ta.grad.numpy(), tb.grad.numpy()]


def _assert_grads(got, want, err_msg="", rtol=0.0, atol=0.0, atol_of_max=0.0):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol + atol_of_max * float(np.abs(w).max()),
                                   err_msg=err_msg)


# ------------------------------------------------------------ helpers
def test_pool_conv_and_gaussian_helpers_match_jax():
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 3, 17, 23)).astype(np.float32)
    np.testing.assert_allclose(
        twindow.avg_pool2d_nchw(torch.from_numpy(x)).numpy(),
        np.asarray(jwindow.avg_pool2d_nchw(jnp.asarray(x))), **HELPER)
    k = rng.standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        twindow.conv2d_same_nchw(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
        np.asarray(jwindow.conv2d_same_nchw(jnp.asarray(x), jnp.asarray(k))),
        **HELPER)
    for sigma in (3.0, 1.5, 0.7):
        got = tmi.gaussian_kernel_1d(sigma)
        assert got.shape == (int(2 * math.ceil(2 * sigma) + 1),)
        np.testing.assert_allclose(got.numpy(), np.asarray(jmi.gaussian_kernel_1d(sigma)),
                                   **HELPER)
    k2 = tmi.gaussian_kernel_2d((3.0, 1.5))
    assert k2.shape == (13, 7)
    np.testing.assert_allclose(k2.numpy(), np.asarray(jmi.gaussian_kernel_2d((3.0, 1.5))),
                               **HELPER)
    img = rng.random((2, 2, 20, 17)).astype(np.float32)
    np.testing.assert_allclose(
        tmi.gaussian_smooth(torch.from_numpy(img), 3.0).numpy(),
        np.asarray(jmi.gaussian_smooth(jnp.asarray(img), 3.0)), **HELPER)


def test_window_convolutions_pin_f32_and_restore_the_flag():
    """The JAX helpers pin HIGHEST precision; the port's turn cuDNN's TF32
    off inside and give the caller's setting back."""
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.rand((1, 1, 12, 12))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(twindow.F, "conv2d", spy)
            twindow.window_sum2d(x, 3, "SAME")
            twindow.avg_pool2d_nchw(x)
            tmi.gaussian_smooth(x, 1.0)
        assert seen == [False] * 4
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("loss", ["lncc", "mi"])
def test_ms_losses_run_every_conv_and_its_backward_without_tf32(loss):
    """The pyramid's backward convolutions run when autograd gets to them,
    after the window helpers have returned: with the caller's TF32 flag on,
    every aten convolution and convolution backward of the ms loss, forward
    and backward, must still see it off, and the flag is the caller's
    after both passes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.convolution.default,
                        torch.ops.aten.convolution_backward.default):
                self.seen.append((func.__name__, torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    fn = {"lncc": tlncc.ms_lncc_loss, "mi": tmi.ms_mi_loss}[loss]
    I, J = _pair(np.random.default_rng(27), (2, 1, 32, 32))
    ti = torch.from_numpy(I).requires_grad_()
    tj = torch.from_numpy(J).requires_grad_()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with Recorder() as rec:
            fn(ti, tj).backward()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    backward = [flag for name, flag in rec.seen if name.startswith("convolution_backward")]
    # 2 coarser scales x 2 images x (smooth, pool)
    assert len(backward) == 8, rec.seen
    assert [flag for _, flag in rec.seen] == [False] * len(rec.seen)
    assert ti.grad is not None and tj.grad is not None


# ------------------------------------------------------------ LNCC
def _near_flat(rng, shape):
    """Exact-zero background (as in MRI), an exactly constant plateau and a
    near-flat band (the +1e-5 denominator path), and one textured patch."""
    n, c, h, w = shape
    x = np.zeros(shape, np.float32)
    x[..., 4:h - 4, 4:w - 4] = 0.5
    x[..., h // 2:h - 4, 4:w - 4] = 0.2 + 1e-2 * rng.standard_normal((n, c, h - 4 - h // 2, w - 8))
    x[..., 6:12, 6:12] = rng.random((n, c, 6, 6))
    return x.astype(np.float32)


LNCC_CASES = {
    "2x1x32x24": ((2, 1, 32, 24), 9, "random"),
    "C2_17x23": ((1, 2, 17, 23), 9, "random"),
    "plane_below_window": ((2, 1, 7, 7), 9, "random"),
    "win5": ((2, 1, 32, 24), 5, "random"),
    "zero_background_near_flat": ((2, 1, 32, 24), 9, "flat"),
}


@pytest.mark.parametrize("case", sorted(LNCC_CASES))
def test_lncc_matches_jnp_and_pallas(case):
    shape, win, kind = LNCC_CASES[case]
    rng = np.random.default_rng(21)
    if kind == "flat":
        I, J = _near_flat(rng, shape), _near_flat(rng, shape)
    else:
        I = rng.random(shape).astype(np.float32)
        J = (0.6 * I + 0.4 * rng.random(shape)).astype(np.float32)
    got = _torch_value_and_grad(lambda a, b: tlncc.lncc_loss(a, b, win), I, J)
    jn = _jax_value_and_grad(lambda a, b: jlncc.lncc_loss(a, b, win, impl="jnp"), I, J)
    pl = _jax_value_and_grad(lambda a, b: lncc_loss_pallas(a, b, win, interpret=True), I, J)
    assert abs(got[0] - jn[0]) < JNP_LNCC_LOSS
    _assert_grads(got[1], jn[1], "vs jnp", **JNP_GRAD)
    assert abs(got[0] - pl[0]) <= PALLAS_LOSS_RTOL * abs(pl[0])
    _assert_grads(got[1], pl[1], "vs pallas",
                  **(JNP_GRAD if kind == "flat" else PALLAS_GRAD))
    # the closed form against torch's autograd of the plain forward

    def autograd(a, b):
        n, c, h, w = a.shape
        return -klncc.lncc_fwd_plain(a, b, win).sum() / (n * c * h * w)

    au = _torch_value_and_grad(autograd, I, J)
    assert got[0] == au[0]
    _assert_grads(got[1], au[1], "vs autograd",
                  **(JNP_GRAD if kind == "flat" else CLOSED_FORM))
    I_var, J_var, cross = tlncc.compute_local_sums(torch.from_numpy(I), torch.from_numpy(J), win)
    for t, j in zip((I_var, J_var, cross), jlncc.compute_local_sums(jnp.asarray(I), jnp.asarray(J), win)):
        # window sums of 81 products, of order 10: rtol 1e-5 / atol 1e-5
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def _in_order(v, n, win, dim):
    """sum_{d < win} of v's slices [d, d + n) along `dim`, added in order
    (the CUDA kernels' separable passes)."""
    acc = v.narrow(dim, 0, n)
    for d in range(1, win):
        acc = acc + v.narrow(dim, d, n)
    return acc


def _lncc_bwd_tiled(I, J, gout, win, tile):
    """The fused CUDA backward's tiling, in torch: a tile of `tile` x `tile`
    outputs stages I and J over itself plus 2 (win/2) a side (zeros
    outside the plane), takes the five window sums at its centres plus
    win/2 a side (rows, then columns, each in order), zeroes the
    coefficients at centres outside the plane, box-sums the five maps over
    its pixels and forms dI, dJ, tile by tile."""
    n, c, h, w = I.shape
    p = win // 2
    S, C, ws = tile + 4 * p, tile + 2 * p, win * win
    edge = (2 * p, 2 * p + tile, 2 * p, 2 * p + tile)  # zeros past every tile
    Ip, Jp = torch.nn.functional.pad(I, edge), torch.nn.functional.pad(J, edge)
    inside = torch.nn.functional.pad(torch.ones_like(I), edge)
    s = gout * (-1.0 / (n * c * h * w))
    dI, dJ = torch.zeros_like(I), torch.zeros_like(J)
    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            # staged (r, c) is pixel (r0 - 2p + r, c0 - 2p + c)
            x = Ip[..., r0:r0 + S, c0:c0 + S]
            y = Jp[..., r0:r0 + S, c0:c0 + S]
            I_s, J_s, I2, J2, IJ = (_in_order(_in_order(v, C, win, 3), C, win, 2)
                                    for v in (x, y, x * x, y * y, x * y))
            cross = IJ - I_s * J_s / ws
            I_var = I2 - I_s * I_s / ws
            J_var = J2 - J_s * J_s / ws
            D = I_var * J_var + klncc.EPS
            Pc = 2.0 * cross / D
            cc_over_D = (cross * cross) / (D * D)
            Pv_I, Pv_J = -cc_over_D * J_var, -cc_over_D * I_var
            G_Is = Pc * (-J_s / ws) + Pv_I * (-2.0 * I_s / ws)
            G_Js = Pc * (-I_s / ws) + Pv_J * (-2.0 * J_s / ws)
            # centre (i, j) is pixel (r0 - p + i, c0 - p + j)
            live = inside[..., r0 + p:r0 + p + C, c0 + p:c0 + p + C]
            b = [_in_order(_in_order(g * live, tile, win, 3), tile, win, 2)
                 for g in (G_Is, G_Js, Pv_I, Pv_J, Pc)]
            xt = x[..., 2 * p:2 * p + tile, 2 * p:2 * p + tile]
            yt = y[..., 2 * p:2 * p + tile, 2 * p:2 * p + tile]
            tI = s * (b[0] + 2.0 * xt * b[2] + yt * b[4])
            tJ = s * (b[1] + 2.0 * yt * b[3] + xt * b[4])
            hh, ww = min(tile, h - r0), min(tile, w - c0)
            dI[..., r0:r0 + hh, c0:c0 + ww] = tI[..., :hh, :ww]
            dJ[..., r0:r0 + hh, c0:c0 + ww] = tJ[..., :hh, :ww]
    return dI, dJ


@pytest.mark.parametrize("shape, win", [
    ((1, 2, 45, 37), 9), ((2, 1, 7, 7), 9), ((1, 1, 45, 37), 1),
    ((1, 1, 45, 37), 5), ((1, 1, 45, 37), 15), ((1, 1, 64, 64), 9)])
def test_lncc_fused_tiling_matches_the_plain_backward(shape, win):
    """The fused CUDA backward's tiles (klncc.TILE a side, the halo rules,
    zero fill outside the plane, zero coefficients at centres outside it)
    give the plain closed form's dI, dJ, in float64 to 1e-6 of max, on
    planes the tile does not divide, a plane below the window and windows
    1 to MAX_WIN; the CUDA source's tile and largest window are these."""
    assert f"constexpr int kTile = {klncc.TILE};" in _csrc("window.cuh")
    assert f"constexpr int kMaxWin = {klncc.MAX_WIN};" in _csrc("lncc.cu")
    rng = np.random.default_rng(28)
    I = torch.from_numpy(rng.random(shape))
    J = 0.6 * I + 0.4 * torch.from_numpy(rng.random(shape))
    g = torch.tensor(0.7, dtype=torch.float64)
    got = _lncc_bwd_tiled(I, J, g, win, klncc.TILE)
    want = klncc.lncc_bwd_plain(I, J, g, win)
    _assert_grads([t.numpy() for t in got], [t.numpy() for t in want], f"win {win}",
                  atol_of_max=1e-6)


def _csrc(name):
    return open(os.path.join(REPO, "spatialalignmentnetwork_tpu_torch", "csrc", name)).read()


FWD_SEG = 4  # csrc/window.cuh kFwdSeg: a thread's outputs in each pass


def _lane0_tree(v):
    """Lane 0's value after the shuffle-down tree over 32 lanes (the last
    dim, zero-padded to 32) that window.cuh's block_sum runs."""
    v = torch.nn.functional.pad(v, (0, 32 - v.shape[-1]))
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _block_sum(v):
    """window.cuh's block_sum of v [..., threads]: a tree a warp, then one
    over the warps' sums."""
    warps = v.reshape(*v.shape[:-1], -1, 32)
    return _lane0_tree(_lane0_tree(warps))


def _fwd_tiled(x, y, win, rows, top, out_h, out_w, per_output):
    """The CUDA forwards' tiling and reduction order (csrc/window.cuh), in
    torch: tiles of `rows` x FWD_COLS outputs, output (i, j) of a tile
    the window whose first pixel is (r0 - top + i, c0 - top + j), staged
    with zeros outside the plane; the five window sums along rows, then
    down columns, each in order; `per_output` of the sums, zero at outputs
    outside out_h x out_w; a thread's FWD_SEG outputs down a column added
    in order, block_sum into the tile's partial; then a plane's partials
    in tile order, thread k taking k, k + threads, ..., and block_sum.
    Returns the per-plane sums [N, C]."""
    n, c, h, w = x.shape
    cols = kernels.FWD_COLS
    tiles_y, tiles_x = -(-out_h // rows), -(-out_w // cols)
    right = max(0, tiles_x * cols + win - 1 - top - w)
    bottom = max(0, tiles_y * rows + win - 1 - top - h)
    xp = torch.nn.functional.pad(x, (top, right, top, bottom))
    yp = torch.nn.functional.pad(y, (top, right, top, bottom))
    ii = torch.arange(rows).view(-1, 1)
    jj = torch.arange(cols).view(1, -1)
    partials = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            r0, c0 = ty * rows, tx * cols
            xs = xp[..., r0:r0 + rows + win - 1, c0:c0 + cols + win - 1]
            ys = yp[..., r0:r0 + rows + win - 1, c0:c0 + cols + win - 1]
            sums = [_in_order(_in_order(v, cols, win, 3), rows, win, 2)
                    for v in (xs, ys, xs * xs, ys * ys, xs * ys)]
            live = (r0 + ii < out_h) & (c0 + jj < out_w)
            val = torch.where(live, per_output(*sums), torch.zeros((), dtype=x.dtype))
            segs = val.reshape(n, c, rows // FWD_SEG, FWD_SEG, cols)
            acc = torch.zeros_like(segs[..., 0, :])
            for t in range(FWD_SEG):
                acc = acc + segs[..., t, :]
            partials.append(_block_sum(acc.reshape(n, c, -1)))  # thread = warp-major
    part = torch.stack(partials, -1)
    threads = rows * cols // FWD_SEG
    acc = torch.zeros((n, c, threads), dtype=x.dtype)
    for k0 in range(0, part.shape[-1], threads):
        chunk = part[..., k0:k0 + threads]
        acc = acc + torch.nn.functional.pad(chunk, (0, threads - chunk.shape[-1]))
    return _block_sum(acc)


def _lncc_cc(win):
    ws = win * win

    def cc(Is, Js, I2, J2, IJ):
        u_I, u_J = Is / ws, Js / ws
        cross = IJ - u_J * Is - u_I * Js + u_I * u_J * ws
        I_var = I2 - 2.0 * u_I * Is + u_I * u_I * ws
        J_var = J2 - 2.0 * u_J * Js + u_J * u_J * ws
        return cross * cross / (I_var * J_var + klncc.EPS)
    return cc


@pytest.mark.parametrize("shape, win", [
    ((1, 2, 45, 37), 9), ((2, 1, 7, 7), 9), ((1, 1, 45, 37), 1), ((1, 1, 45, 37), 5),
    ((1, 1, 45, 37), 15), ((4, 1, 160, 160), 9), ((4, 1, 80, 80), 9)])
def test_lncc_fwd_tiling_matches_the_plain_forward(shape, win):
    """The one-launch CUDA forward's tiles (every tile height on the small
    planes, the tile rule's on 132 SMs at ms_lncc_loss's 160² and 80²;
    win/2 a side of zeros outside the plane, outputs outside the plane
    dropped) and its reduction order give the plain forward's per-plane
    sums, in float64 to 1e-12 relative, on planes the tile does not divide,
    a plane below the window and windows 1 to MAX_WIN; the CUDA source's
    tile constants are these."""
    hdr = _csrc("window.cuh")
    assert f"constexpr int kFwdCols = {kernels.FWD_COLS};" in hdr
    assert f"constexpr int kFwdSeg = {FWD_SEG};" in hdr
    n, c, h, w = shape
    rule = {(4, 1, 160, 160): 32, (4, 1, 80, 80): 8}.get(shape)
    if rule:
        assert kernels.fwd_rows(n * c, h, w, 132) == rule
    rng = np.random.default_rng(29)
    I = torch.from_numpy(rng.random(shape))
    J = 0.6 * I + 0.4 * torch.from_numpy(rng.random(shape))
    want = klncc.lncc_fwd_plain(I, J, win)
    for rows in [rule] if rule else kernels.FWD_ROWS:
        got = _fwd_tiled(I, J, win, rows, win // 2, h, w, _lncc_cc(win))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0,
                                   err_msg=f"{rows} rows")


@pytest.mark.parametrize("planes, rows, cols, sms, th", [
    (4, 320, 320, 132, 32), (4, 160, 160, 132, 32), (4, 80, 80, 132, 8),
    (4, 314, 314, 132, 32), (4, 154, 154, 132, 32), (4, 74, 74, 132, 8),
    (8, 80, 80, 132, 32), (4, 80, 80, 114, 16), (1, 1, 1, 132, 8),
    (65535, 7, 7, 132, 32)])
def test_fwd_tile_rule_picks_the_rows_the_sources_take(planes, rows, cols, sms, th):
    """kernels.fwd_rows: the tallest tile whose grid has a block for every
    other SM (32 rows at 320² and 160², 8 at 80² on 132 SMs), from the
    heights each forward's entry point takes."""
    assert kernels.fwd_rows(planes, rows, cols, sms) == th
    for src in ("lncc.cu", "ssim.cu"):
        cases = [int(k) for k in re.findall(r"case (\d+): return launch_fwd<",
                                            _csrc(src))]
        assert sorted(set(cases)) == sorted(kernels.FWD_ROWS), src


# ------------------------------------------------------------ MI
MI_CASES = {
    "48x48_two_chunks": ((2, 1, 48, 48), {}, (0.0, 1.0)),
    "33x31": ((2, 1, 33, 31), {}, (0.0, 1.0)),
    "values_out_of_range": ((2, 1, 24, 24), {}, (-0.3, 1.3)),
    "bins32_range_-0.5_1.5": ((2, 1, 24, 24), dict(bins=32, minVal=-0.5, maxVal=1.5),
                              (-0.5, 1.5)),
}


@pytest.mark.parametrize("case", sorted(MI_CASES))
def test_mi_matches_jnp_and_pallas(case):
    shape, kw, (lo, hi) = MI_CASES[case]
    rng = np.random.default_rng(22)
    I = (lo + (hi - lo) * rng.random(shape)).astype(np.float32)
    J = np.clip(I + 0.1 * rng.standard_normal(shape), lo, hi).astype(np.float32)
    parzen = (kw.get("bins", 64), 1.0 / 64, kw.get("minVal", 0.0), kw.get("maxVal", 1.0))
    got = _torch_value_and_grad(lambda a, b: tmi.mi_loss(a, b, **kw), I, J)
    jn = _jax_value_and_grad(lambda a, b: jmi.mi_loss(a, b, impl="jnp", **kw), I, J)
    pl = _jax_value_and_grad(lambda a, b: mi_loss_pallas(a, b, *parzen, interpret=True), I, J)
    assert abs(got[0] - jn[0]) < JNP_MI_LOSS
    _assert_grads(got[1], jn[1], "vs jnp", **JNP_GRAD)
    assert abs(got[0] - pl[0]) <= PALLAS_LOSS_RTOL * abs(pl[0])
    _assert_grads(got[1], pl[1], "vs pallas", **PALLAS_GRAD)
    au = _torch_value_and_grad(lambda a, b: kmi.mi_fwd_plain(a, b, *parzen)[0], I, J)
    assert got[0] == au[0]
    _assert_grads(got[1], au[1], "vs autograd", **CLOSED_FORM)


def _reduce_then_subtract(I, J):
    """dL/dI of the f32 MI loss in the cancelling form the JAX package
    replaced (ops/pallas/mi.py:357-365): sum_b A_b c_b - v sum_b A_b."""
    n, bins, sigma = I.shape[0], 64, 1.0 / 64
    stats = kmi.mi_fwd_plain(I, J)[1]
    vi, vj = I.reshape(n, -1), J.reshape(n, -1)
    centers, p_i = kmi._parzen(vi, bins, sigma, 0.0, 1.0)
    _, p_j = kmi._parzen(vj, bins, sigma, 0.0, 1.0)
    A = kmi.dloss_dresponses(stats, p_i, p_j, vi.shape[1], bins, sigma)[0] * p_i
    d = ((A * centers[None, :, None]).sum(1) - vi * A.sum(1)) / (sigma * sigma)
    return (d / n).reshape(I.shape)


def test_mi_backward_does_not_cancel_near_the_top_bin():
    """The MI cancellation watch-list item: on inputs near 1, where each
    pixel sits close to the centres that carry its weight, the f32
    closed-form backward stays within 3e-6 of the largest gradient of the
    float64 gradient (torch autograd of the plain forward in float64),
    while the reduce-then-subtract form misses that bar."""
    rng = np.random.default_rng(23)
    shape = (2, 1, 24, 24)
    I = (0.9 + 0.1 * rng.random(shape)).astype(np.float32)
    J = np.clip(I + 0.01 * rng.standard_normal(shape), 0.9, 1.0).astype(np.float32)
    got = _torch_value_and_grad(lambda a, b: tmi.mi_loss(a, b), I, J)
    f64 = _torch_value_and_grad(lambda a, b: kmi.mi_fwd_plain(a, b)[0],
                                I.astype(np.float64), J.astype(np.float64))
    tol = 3e-6 * float(np.abs(f64[1][0]).max())
    for g, w in zip(got[1], f64[1]):
        assert float(np.abs(g - w).max()) <= tol
    cancelling = _reduce_then_subtract(torch.from_numpy(I), torch.from_numpy(J)).numpy()
    assert float(np.abs(cancelling - f64[1][0]).max()) > tol


def _tf32(v):
    """float32 v rounded to TF32 as `cvt.rna.tf32.f32` rounds it: 10
    mantissa bits, ties away from zero (half the weight of the 13 dropped
    bits added to the magnitude, then the bits dropped)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mi_grads_emulated(I, J, three):
    """dL/dI, dL/dJ of the f32 MI loss with the backward's two products
    (EQ p_J and EQ^T p_I) as csrc/mi.cu's pixel kernel takes them: every
    operand split into hi = tf32(v) and lo = tf32(v - hi), each product as
    lo.hi + hi.lo + hi.hi (three = True, 3xTF32) or hi.hi alone (TF32),
    each product of two TF32 values exact in f32, summed in f32."""
    n, bins, sigma = I.shape[0], 64, 1.0 / 64
    stats = kmi.mi_fwd_plain(I, J)[1]
    vi, vj = I.reshape(n, -1), J.reshape(n, -1)
    centers, p_i = kmi._parzen(vi, bins, sigma, 0.0, 1.0)
    _, p_j = kmi._parzen(vj, bins, sigma, 0.0, 1.0)
    w_i, w_j, EQ = kmi.entropy_coefficients(stats, vi.shape[1], bins, sigma)

    def product(a, b):
        hi = lambda x: torch.from_numpy(_tf32(x.contiguous().numpy()))
        ah, bh = hi(a), hi(b)
        if not three:
            return ah @ bh
        al, bl = hi(a - ah), hi(b - bh)
        return (al @ bh + ah @ bl) + ah @ bh

    norm2d = 2.0 * math.pi * sigma * sigma
    dLdp_i = w_i[:, :, None] + product(EQ, p_j) / norm2d
    dLdp_j = w_j[:, :, None] + product(EQ.transpose(1, 2), p_i) / norm2d

    def pixel_grad(dLdp, p, v):  # subtract, then reduce over bins
        return ((dLdp * p) * (centers[None, :, None] - v[:, None, :])).sum(1) / (
            sigma * sigma * n)

    return pixel_grad(dLdp_i, p_i, vi).numpy(), pixel_grad(dLdp_j, p_j, vj).numpy()


@pytest.mark.parametrize("case", ["near_top_bin_24x24", "random_64x64"])
def test_mi_3xtf32_emulation_meets_the_f64_bar_and_tf32_misses_it(case):
    """The MI backward kernel's arithmetic (csrc/mi.cu, 3xTF32 products on
    the tensor cores), emulated on the CPU: on the inputs of
    test_mi_backward_does_not_cancel_near_the_top_bin it lands within
    chip_smoke.MI_F64_TOL = 3e-6 of max of the float64 gradient (torch
    autograd of the plain forward in float64), and on random inputs within
    chip_smoke.MI_GRAD_TOL = 5e-5, the bars the kernel is held to on the
    card; plain TF32 (hi.hi alone) misses the bar on the same inputs."""
    if case == "near_top_bin_24x24":
        rng, shape, bar = np.random.default_rng(23), (2, 1, 24, 24), 3e-6
        I = (0.9 + 0.1 * rng.random(shape)).astype(np.float32)
        J = np.clip(I + 0.01 * rng.standard_normal(shape), 0.9, 1.0).astype(np.float32)
    else:
        rng, shape, bar = np.random.default_rng(22), (2, 1, 64, 64), 5e-5
        I = rng.random(shape).astype(np.float32)
        J = np.clip(I + 0.1 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    f64 = _torch_value_and_grad(lambda a, b: kmi.mi_fwd_plain(a, b)[0],
                                I.astype(np.float64), J.astype(np.float64))[1]
    scale = max(float(np.abs(g).max()) for g in f64)

    def err(three):
        got = _mi_grads_emulated(torch.from_numpy(I), torch.from_numpy(J), three)
        return max(float(np.abs(g.reshape(w.shape) - w).max()) for g, w in zip(got, f64)) / scale

    err3, err1 = err(True), err(False)
    assert err3 <= bar < err1, (err3, err1)


def _fma32(a, b, c):
    """fmaf(a, b, c) on float32 values: a b + c exactly, rounded once to
    float32, to nearest with ties to even."""
    from fractions import Fraction

    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(x))
    cands = (np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


def test_mi_response_quotient_is_the_divide_to_the_bit():
    """csrc/mi.cu's backward takes a response's quotient e / norm1d
    without the IEEE divide (whose slow path, for the 0 and subnormal e
    most bins give, and whose branch cost the kernel most of its time):
    q0 = RN(e r) with r = RN(1 / norm1d), then q = fma(fma(-norm1d, q0, e),
    r, q0). For e >= 2^-100 that is the divide's result to the bit
    (Markstein's theorem), checked here over the Gaussians' range."""
    norm1d = np.float32(math.sqrt(2.0 * math.pi) / 64)
    r = np.float32(1.0) / norm1d
    rng = np.random.default_rng(9)
    e = np.concatenate([np.exp(-rng.uniform(0, 69.3, 1500)),
                        2.0 ** -rng.uniform(0, 100, 1500), [1.0, 2.0**-100]]).astype(np.float32)
    for x in e:
        q0 = np.float32(x * r)
        q = _fma32(_fma32(-norm1d, q0, x), r, q0)
        assert q == x / norm1d, (x, q, x / norm1d)


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _mi_stats_emulated(I, J, three):
    """The MI forward kernel's statistics (csrc/mi.cu's Gram launch and the
    sum of its partials), emulated: the f32 responses' marginal sums, and
    the joint Gram P_I P_J^T over tiles of 64 pixels (zero-padded), each
    operand split into hi = tf32(v) and lo = tf32(v - hi), a tile's product
    as lo.hi + hi.lo + hi.hi (three = True, 3xTF32) or hi.hi alone (TF32)
    into a fresh f32 sum, then added in f32 to the running sum."""
    n, bins, sigma, tile = I.shape[0], 64, 1.0 / 64, kmi.FWD_TILE
    vi, vj = I.reshape(n, -1), J.reshape(n, -1)
    _, p_i = kmi._parzen(vi, bins, sigma, 0.0, 1.0)
    _, p_j = kmi._parzen(vj, bins, sigma, 0.0, 1.0)
    m = vi.shape[1]
    pad = -m % tile
    hi = lambda x: torch.from_numpy(_tf32(x.contiguous().numpy()))
    joint = torch.zeros((n, bins, bins))
    for k in range(0, m + pad, tile):
        a = torch.nn.functional.pad(p_i, (0, pad))[:, :, k:k + tile]
        b = torch.nn.functional.pad(p_j, (0, pad))[:, :, k:k + tile].transpose(1, 2)
        ah, bh = hi(a), hi(b)
        if three:
            al, bl = hi(a - ah), hi(b - bh)
            joint = joint + ((al @ bh + ah @ bl) + ah @ bh)
        else:
            joint = joint + ah @ bh
    return torch.cat([p_i.sum(2), p_j.sum(2), joint.reshape(n, -1)], 1)


@pytest.mark.parametrize("case", ["near_top_bin_24x24", "random_64x64"])
def test_mi_fwd_3xtf32_emulation_meets_the_stats_bar_and_tf32_misses_it(case):
    """The MI forward kernel's arithmetic (csrc/mi.cu, the joint Gram as
    3xTF32 on the tensor cores, a fresh sum each 64 pixels), emulated on
    the CPU: its statistics land within chip_smoke.MI_STATS_TOL of max of
    the float64 plain forward's, its loss within MI_LOSS_ATOL, where TF32
    alone (hi.hi) misses the statistics bar; near the top bin the f32
    closed-form backward fed its statistics stays within MI_F64_TOL of max
    of the float64 gradient, where fed TF32's it does not. These are the
    bars the kernels are held to on the card."""
    cs = _chip_smoke()
    if case == "near_top_bin_24x24":
        rng, shape = np.random.default_rng(23), (2, 1, 24, 24)
        I = (0.9 + 0.1 * rng.random(shape)).astype(np.float32)
        J = np.clip(I + 0.01 * rng.standard_normal(shape), 0.9, 1.0).astype(np.float32)
    else:
        rng, shape = np.random.default_rng(22), (2, 1, 64, 64)
        I = rng.random(shape).astype(np.float32)
        J = np.clip(I + 0.1 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    tI, tJ = torch.from_numpy(I), torch.from_numpy(J)
    I64 = tI.double().requires_grad_()
    J64 = tJ.double().requires_grad_()
    loss64, stats64 = kmi.mi_fwd_plain(I64, J64)
    loss64.backward()
    loss64, stats64 = float(loss64.detach()), stats64.detach()
    m = I[0].size

    def errs(three):
        stats = _mi_stats_emulated(tI, tJ, three)
        e_stats = float((stats.double() - stats64).abs().max() / stats64.abs().max())
        e_loss = abs(float(kmi.neg_mi(stats, m, 64, 1.0 / 64).mean()) - loss64)
        got = kmi.mi_bwd_plain(tI, tJ, stats, torch.ones(()))
        scale = max(float(I64.grad.abs().max()), float(J64.grad.abs().max()))
        e_grad = max(float((g.double() - w).abs().max())
                     for g, w in zip(got, (I64.grad, J64.grad))) / scale
        return e_stats, e_loss, e_grad

    (s3, l3, g3), (s1, _, g1) = errs(True), errs(False)
    assert s3 <= cs.MI_STATS_TOL < s1, (s3, s1)
    assert l3 <= cs.MI_LOSS_ATOL, l3
    if case == "near_top_bin_24x24":
        assert g3 <= cs.MI_F64_TOL < g1, (g3, g1)
    else:
        assert g3 <= cs.MI_GRAD_TOL, g3


@pytest.mark.parametrize("n, m, sms, blocks", [
    (4, 320 * 320, 132, 66), (4, 160 * 160, 132, 66), (4, 80 * 80, 132, 66),
    (8, 320 * 320, 132, 33), (2, 317 * 301, 132, 132), (1, 49, 132, 1),
    (3, 5 * 64, 132, 5), (3, 5 * 64 + 1, 132, 6), (4, 320 * 320, 114, 57),
    (264, 4096, 132, 1), (65535, 64, 132, 1)])
def test_mi_fwd_grid_and_partials_follow_one_rule(monkeypatch, n, m, sms, blocks):
    """The CUDA forward's blocks a sample fill the card once (2 an SM, the
    Gram kernel's __launch_bounds__ minimum in csrc/mi.cu) at every plane,
    at most one a 64-pixel tile; mi_fwd_cuda sizes the partials' scratch
    (one partial of 4224 floats a block) and the launch from that one
    number, so no block writes past the scratch."""
    assert kmi.fwd_blocks(n, m, sms) == blocks
    src = open(os.path.join(REPO, "spatialalignmentnetwork_tpu_torch", "csrc", "mi.cu")).read()
    assert f"constexpr int kFwdBlocks = {kmi.FWD_BLOCKS_PER_SM};" in src
    assert f"constexpr int kFwdTile = {kmi.FWD_TILE};" in src
    if n * m > 2**20:
        return  # the rule alone; the wrapper below at the smaller sizes
    sizes, args = [], []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    class Props:
        multi_processor_count = sms

    monkeypatch.setattr(kmi, "_check_cuda", lambda *t: None)
    monkeypatch.setattr(kmi.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kmi.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kmi.torch.cuda, "get_device_properties", lambda dev: Props())
    monkeypatch.setattr(kmi.torch, "empty", empty)
    monkeypatch.setattr(kmi, "_launcher", lambda symbol: lambda *a: args.append(a) or 0)
    x = real_empty((n, 1, m))
    kmi.mi_fwd_cuda(x, x)
    kernels.reset_launches()
    (a,) = args
    assert a[9] == blocks and len(a) == len(kmi._ARGTYPES["san_mi_fwd"])
    assert sizes[0] == n * blocks * (2 * 64 + 64 * 64)


# ------------------------------------------------------------ multi-scale
def _pair(rng, shape):
    I = rng.random(shape).astype(np.float32)
    J = np.clip(0.7 * I + 0.3 * rng.random(shape), 0, 1).astype(np.float32)
    return I, J


@pytest.mark.parametrize("loss", ["lncc", "mi"])
def test_ms_losses_match_jax(loss):
    rng = np.random.default_rng(24)
    I, J = _pair(rng, (2, 1, 32, 32))
    if loss == "lncc":
        got = _torch_value_and_grad(tlncc.ms_lncc_loss, I, J)
        want = _jax_value_and_grad(jlncc.ms_lncc_loss, I, J)
        assert abs(got[0] - want[0]) < JNP_LNCC_LOSS
    else:
        got = _torch_value_and_grad(tmi.ms_mi_loss, I, J)
        want = _jax_value_and_grad(jmi.ms_mi_loss, I, J)
        assert abs(got[0] - want[0]) < JNP_MI_LOSS
    _assert_grads(got[1], want[1], loss, **JNP_GRAD)


@pytest.mark.parametrize("loss", ["lncc", "mi"])
def test_warp_then_ms_loss_matches_jax(loss):
    """The slice as a whole: ms loss of (target, warp(aux, grid)), with
    gradients to the image and the grid, port against JAX."""
    rng = np.random.default_rng(25)
    n, size = 2, 32
    target, aux = _pair(rng, (n, 1, size, size))
    coarse = rng.standard_normal((n, 2, 4, 4)).astype(np.float32)
    off = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(size, size),
                                          mode="bilinear", align_corners=True)
    grid = (np.broadcast_to(np.asarray(jidentity_grid((n, 1, size, size))), (n, size, size, 2))
            + 0.03 * off.permute(0, 2, 3, 1).numpy()).astype(np.float32)
    t_fn = {"lncc": tlncc.ms_lncc_loss, "mi": tmi.ms_mi_loss}[loss]
    j_fn = {"lncc": jlncc.ms_lncc_loss, "mi": jmi.ms_mi_loss}[loss]
    got = _torch_value_and_grad(lambda a, g: t_fn(torch.from_numpy(target), warp(a, g)),
                                aux, grid)
    want = _jax_value_and_grad(lambda a, g: j_fn(jnp.asarray(target), jwarp(a, g)), aux, grid)
    assert abs(got[0] - want[0]) < {"lncc": JNP_LNCC_LOSS, "mi": JNP_MI_LOSS}[loss]
    _assert_grads(got[1], want[1], loss, **JNP_GRAD)


# ------------------------------------------------------------ card route
@pytest.mark.parametrize("loss", ["lncc", "mi"])
def test_mocked_card_route_keeps_the_gradient(monkeypatch, loss):
    """The card's route through each autograd Function, with the CUDA
    wrappers standing in as their plain versions: the loss has the Function
    as its grad_fn (a ctypes-filled tensor alone would have none), backward
    runs the backward wrapper once, and the gradients equal torch's
    autograd of the plain forward."""
    mod = {"lncc": klncc, "mi": kmi}[loss]
    calls = []

    def standin(name, fn):
        def run(*args):
            calls.append(name)
            return fn(*args)
        return run

    plain_fwd = getattr(mod, f"{loss}_fwd_plain")
    monkeypatch.setattr(mod, "on_card", lambda t: True)
    monkeypatch.setattr(mod, f"{loss}_fwd_cuda", standin("fwd", plain_fwd))
    monkeypatch.setattr(mod, f"{loss}_bwd_cuda",
                        standin("bwd", getattr(mod, f"{loss}_bwd_plain")))
    rng = np.random.default_rng(26)
    I, J = _pair(rng, (2, 1, 16, 16))
    ti = torch.from_numpy(I).requires_grad_()
    tj = torch.from_numpy(J).requires_grad_()
    out = {"lncc": tlncc.lncc_loss, "mi": tmi.mi_loss}[loss](ti, tj)
    assert type(out.grad_fn).__name__ == {"lncc": "LNCCLossBackward",
                                          "mi": "MILossBackward"}[loss]
    out.backward()
    assert calls == ["fwd", "bwd"]
    ai = torch.from_numpy(I).requires_grad_()
    aj = torch.from_numpy(J).requires_grad_()
    if loss == "lncc":
        (-plain_fwd(ai, aj).sum() / ai.numel()).backward()
    else:
        plain_fwd(ai, aj)[0].backward()
    _assert_grads([ti.grad.numpy(), tj.grad.numpy()], [ai.grad.numpy(), aj.grad.numpy()],
                  loss, **CLOSED_FORM)


def test_wrappers_raise_without_launching(monkeypatch):
    launched = []
    for mod in (klncc, kmi):
        monkeypatch.setattr(mod, "_launcher", lambda symbol: launched.append(symbol))
    kernels.reset_launches()
    x = torch.rand((2, 1, 8, 8))
    g = torch.ones(())
    stats = torch.zeros((2, 2 * 64 + 64 * 64))
    with pytest.raises(TypeError):  # float32 only
        klncc.lncc_fwd_cuda(x.double(), x.double())
    with pytest.raises(TypeError):
        kmi.mi_fwd_cuda(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        klncc.lncc_bwd_cuda(x.transpose(2, 3), x, g)
    with pytest.raises(ValueError, match="contiguous"):
        kmi.mi_bwd_cuda(x.transpose(2, 3), x, stats, g)
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors never reach a kernel
        klncc.lncc_fwd_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kmi.mi_bwd_cuda(x, x, stats, g)
    for win in (4, 17, 0):
        with pytest.raises(ValueError, match="window"):
            klncc.lncc_fwd_cuda(x, x, win)
        with pytest.raises(ValueError, match="window"):
            tlncc.lncc_loss(x, x, win)
    for bins in (1, 65):
        with pytest.raises(ValueError, match="bins"):
            kmi.mi_fwd_cuda(x, x, bins)
        with pytest.raises(ValueError, match="bins"):
            tmi.mi_loss(x, x, bins)
    with pytest.raises(ValueError):
        tlncc.lncc_loss(x[0], x[0])  # [N, C, H, W] only
    assert launched == [] and not kernels.LAUNCHES


def test_chip_smoke_registration_phase_runs_on_cpu():
    """chip_smoke.py's registration-loss phase on the CPU at a small shape:
    its logic is exercised here, its numbers only on a card."""
    launches, ms = _chip_smoke().check_registration(
        np.random.default_rng(0), device="cpu", shape=32, batch=2)
    assert launches == {}  # CPU tensors take the plain versions
    assert set(ms) == {"lncc_loss", "ms_lncc_loss", "mi_loss", "ms_mi_loss"}
