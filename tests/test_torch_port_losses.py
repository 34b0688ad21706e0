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

import math
import os
import sys

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
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    launches, ms = chip_smoke.check_registration(
        np.random.default_rng(0), device="cpu", shape=32, batch=2)
    assert launches == {}  # CPU tensors take the plain versions
    assert set(ms) == {"lncc_loss", "ms_lncc_loss", "mi_loss", "ms_mi_loss"}
