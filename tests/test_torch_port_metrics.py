"""The PyTorch port's eval metrics against the JAX package, on the CPU.

`utils/metrics.py` (the port's numpy copy) is held against the JAX
package's numpy `utils/metrics.py`, and `utils/metrics_torch.py` against
`utils/metrics_jax.py`, whole-batch and per-slice forms, on the same
seeded numpy inputs. The inputs hold values at exactly 0, 1, bin edges
k/64 and outside [0, 1], which the MI histogram must bin as
np.histogram2d does (the right edge closed). Bars: rtol 1e-5 (f32 sums in
another order); the joint histograms equal count for count; MI rtol 1e-6
of the value (the same counts, then f32 sums over 4096 bins in another
order). The SSIM metric goes through `ops/ssim.py::ssim_per_plane`, the
SSIM forward kernel's plain version on the CPU.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.utils import metrics as jnp_metrics
from spatialalignmentnetwork_tpu.utils import metrics_jax as jmetrics

from spatialalignmentnetwork_tpu_torch.ops.ssim import ssim_map, ssim_per_plane
from spatialalignmentnetwork_tpu_torch.utils import metrics as tnp_metrics
from spatialalignmentnetwork_tpu_torch.utils import metrics_torch as tmetrics

torch.set_num_threads(2)
RTOL = 1e-5
MI_RTOL = 1e-6
WHOLE = ("mse", "mae", "nmse", "psnr", "ssim", "mi")
PER_SLICE = ("mse", "mae", "ssim", "mi")  # the JAX package's *_per_slice


def _pair(seed, n=3, size=20, noise=0.1):
    """gt in [0, 1) and a noisy pred, with exact 0, 1, bin edges k/64 and
    values outside [0, 1] planted in both."""
    rng = np.random.default_rng(seed)
    gt = rng.random((n, 1, size, size)).astype(np.float32)
    pred = (gt + noise * rng.standard_normal(gt.shape)).astype(np.float32)
    edges = np.array([0.0, 1.0, 1 / 64, 63 / 64, 0.5, 32 / 64, 2 / 64, 1.0], np.float32)
    gt[:, 0, 0, :8] = edges
    pred[:, 0, 0, :8] = edges[::-1]
    pred[:, 0, 1, :4] = [-0.0, 1.0000001, -1e-8, 1.5]
    gt[:, 0, 2, :3] = [1.0, 0.0, 63 / 64]
    return gt, pred


def _close(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["psnr", "ssim", "mi", "mse", "mae", "nmse"])
def test_numpy_metrics_match_jax_package(name, seed):
    gt, pred = _pair(seed)
    if name == "psnr":
        pred = np.clip(pred, 0, 1)
    want = getattr(jnp_metrics, name)(gt, pred)
    got = getattr(tnp_metrics, name)(gt, pred)
    assert isinstance(got, float)
    _close(got, want, MI_RTOL if name == "mi" else RTOL, name)


@pytest.mark.parametrize("label", [None, 1, 2])
def test_numpy_dice_matches_jax_package(label):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 3, (2, 1, 9, 9))
    b = rng.integers(0, 3, (2, 1, 9, 9))
    assert tnp_metrics.dice(a, b, label) == jnp_metrics.dice(a, b, label)
    zeros = np.zeros((1, 1, 4, 4))
    assert tnp_metrics.dice(zeros, zeros) == jnp_metrics.dice(zeros, zeros) == 1.0


def test_numpy_metrics_refuse_other_ranks():
    with pytest.raises(ValueError, match="expected"):
        tnp_metrics.mse(np.zeros((4, 4)), np.zeros((4, 4)))


@pytest.mark.parametrize("seed,size", [(0, 20), (1, 16), (2, 33)])
@pytest.mark.parametrize("name", WHOLE)
def test_torch_metrics_match_jax(name, seed, size):
    gt, pred = _pair(seed, size=size)
    want = np.asarray(getattr(jmetrics, name)(jnp.asarray(gt), jnp.asarray(pred)))
    got = getattr(tmetrics, name)(torch.from_numpy(gt), torch.from_numpy(pred))
    assert got.shape == () and got.dtype == torch.float32
    _close(got.numpy(), want, MI_RTOL if name == "mi" else RTOL, name)


@pytest.mark.parametrize("seed,size", [(0, 20), (1, 16), (2, 33)])
@pytest.mark.parametrize("name", PER_SLICE)
def test_torch_per_slice_metrics_match_jax(name, seed, size):
    gt, pred = _pair(seed, n=4, size=size)
    fn = f"{name}_per_slice"
    want = np.asarray(getattr(jmetrics, fn)(jnp.asarray(gt), jnp.asarray(pred)))
    got = getattr(tmetrics, fn)(torch.from_numpy(gt), torch.from_numpy(pred))
    assert got.shape == (4,)
    _close(got.numpy(), want, MI_RTOL if name == "mi" else RTOL, fn)


@pytest.mark.parametrize("name", ["nmse", "psnr"])
def test_torch_nmse_and_psnr_per_slice_are_the_whole_forms_a_slice(name):
    """The JAX package has no per-slice nmse or psnr: each slice's value is
    its whole-batch form on that slice alone."""
    gt, pred = _pair(3, n=3)
    got = getattr(tmetrics, f"{name}_per_slice")(torch.from_numpy(gt), torch.from_numpy(pred))
    want = [np.asarray(getattr(jmetrics, name)(jnp.asarray(gt[i:i + 1]),
                                               jnp.asarray(pred[i:i + 1])))
            for i in range(3)]
    _close(got.numpy(), want, RTOL, name)


@pytest.mark.parametrize("bins", [64, 32, 7])
def test_hist2d_equals_jax_count_for_count(bins):
    """Every value of _pair's planted edges, NaN and +-inf included: NaN and
    out-of-range values count nowhere, 1.0 counts in the last bin."""
    gt, pred = _pair(4, n=2, size=24)
    gt[0, 0, 5, :3] = [np.nan, np.inf, -np.inf]
    pred[1, 0, 6, :2] = [np.nan, 0.25]
    x, y = gt.reshape(2, -1), pred.reshape(2, -1)
    got = tmetrics._hist2d_64(torch.from_numpy(x), torch.from_numpy(y), bins)
    assert got.shape == (2, bins, bins)
    for i in range(2):
        want = np.asarray(jmetrics._hist2d_64(jnp.asarray(x[i]), jnp.asarray(y[i]), bins))
        np.testing.assert_array_equal(got[i].numpy(), want)
        finite = np.isfinite(x[i]) & np.isfinite(y[i])
        ref = np.histogram2d(x[i][finite], y[i][finite], bins, range=((0, 1), (0, 1)))[0]
        np.testing.assert_array_equal(got[i].numpy(), ref)


def test_xlogy_zero_rule_matches_jax():
    x = np.array([0.0, 0.0, 0.5, 1.0, 0.25, 0.0], np.float32)
    y = np.array([0.0, 2.0, 0.5, 1.0, 0.0, np.inf], np.float32)
    want = np.asarray(jmetrics._xlogy(jnp.asarray(x), jnp.asarray(y)))
    got = tmetrics._xlogy(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 1, 20, 20), (2, 2, 7, 9), (1, 3, 16, 31)])
def test_ssim_per_plane_is_the_map_mean_a_plane(shape):
    """ssim_per_plane (the SSIM forward's per-plane sums over its windows)
    against the mean of the port's plain map and of the JAX package's."""
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    got = ssim_per_plane(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == shape[:2] and not got.requires_grad
    plain = ssim_map(torch.from_numpy(x), torch.from_numpy(y)).mean(dim=(2, 3))
    _close(got.numpy(), plain.numpy(), RTOL, "plain map")
    from spatialalignmentnetwork_tpu.ops.ssim import ssim_map as jssim_map

    want = np.asarray(jssim_map(jnp.asarray(x), jnp.asarray(y))).mean(axis=(2, 3))
    _close(got.numpy(), want, RTOL, "JAX map")


def test_ssim_per_plane_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="real"):
        ssim_per_plane(torch.zeros(1, 1, 8, 8, dtype=torch.complex64),
                       torch.zeros(1, 1, 8, 8, dtype=torch.complex64))
    with pytest.raises(ValueError, match="at least 7x7"):
        ssim_per_plane(torch.zeros(1, 1, 6, 8), torch.zeros(1, 1, 6, 8))


def test_torch_metrics_against_the_numpy_copy():
    """The device metrics against the host ones on images in [0, 1] (the
    numpy ssim and psnr take float64: f32's distance from it)."""
    gt, pred = _pair(5, n=3, size=24)
    pred = np.clip(pred, 0, 1)
    t = {k: float(getattr(tmetrics, k)(torch.from_numpy(gt), torch.from_numpy(pred)))
         for k in WHOLE}
    for k in WHOLE:
        _close(t[k], getattr(tnp_metrics, k)(gt, pred), 1e-5, k)


def test_mi_of_float64_inputs_is_computed_in_float64():
    """A float64 MI (the chip check's reference) counts, normalises and sums
    in float64: it equals the numpy copy's float64 MI to float64 rounding,
    and the f32 MI of the same values lies within f32 rounding of it."""
    gt, pred = _pair(6, n=3, size=24)
    gt64, pred64 = torch.from_numpy(gt).double(), torch.from_numpy(pred).double()
    got = tmetrics.mi_per_slice(gt64, pred64)
    assert got.dtype == torch.float64
    want = [tnp_metrics.mi(gt[i:i + 1].astype(np.float64), pred[i:i + 1].astype(np.float64))
            for i in range(3)]
    _close(got.numpy(), want, 1e-12, "float64 mi")
    f32 = tmetrics.mi_per_slice(torch.from_numpy(gt), torch.from_numpy(pred))
    assert f32.dtype == torch.float32
    _close(f32.numpy(), got.numpy(), MI_RTOL, "f32 mi vs float64")
