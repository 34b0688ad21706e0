"""The d_img kernel's fixed-point arithmetic, emulated on the CPU
(`kernels.grid_sample.grid_sample_bwd_dimg_fixed`), against the JAX
package and float64.

The kernel sums each tap's contribution as the int64 8 round(g w 2^k),
with 2^k a plane's scale from `fixed_point_exponent`, and flags
non-finite contributions in the words' low bits. Here: the emulation
against `jax.vjp` through the Pallas kernel in interpret mode (its custom
VJP) at the grid-sample gradient tolerance (rtol 1e-4, atol 1e-5); against
the plain version in float64 within 1e-6 of each plane's max (the
fixed-point rounding is about 2^-40 of it, the f32 result's half an ulp); the
same bits when the output pixels come in another order; the scale's
headroom at the largest plane the kernel takes; zero and non-finite
planes against the plain version. Inputs come from numpy seeds.
"""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialalignmentnetwork_tpu.ops.pallas.grid_sample import grid_sample_pallas
from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs
from tests.test_torch_port_ops import GS_GRAD, _boundary_grid, _grids

torch.set_num_threads(2)
F64_TOL = 1e-6  # of each plane's max |d_img|
MODES = ["zeros", "border", "reflection"]


def _plane_err(got, want):
    """max over planes of max |got - want| / max |want| of the plane."""
    diff = (got.to(torch.float64) - want).abs().amax((2, 3))
    return float((diff / want.abs().amax((2, 3)).clamp_min(1e-300)).max())


def _inputs(seed, n=2, c=3, hw=(24, 32), out=(16, 24), spread=0.8):
    rng = np.random.default_rng(seed)
    grid = (rng.standard_normal((n, *out, 2)) * spread).astype(np.float32)
    g = rng.standard_normal((n, c, *out)).astype(np.float32)
    return torch.from_numpy(grid), torch.from_numpy(g), (n, c, *hw)


@pytest.mark.parametrize("shapes", [((16, 16), (16, 16)), ((24, 32), (16, 24))])
@pytest.mark.parametrize("padding_mode", MODES)
def test_fixed_dimg_matches_pallas_vjp(shapes, padding_mode):
    """d_img by the kernel's arithmetic against jax.vjp through the Pallas
    kernel (interpreted) on the grids of the plain backward's test."""
    (h, w), (ho, wo) = shapes
    n, c = 2, 3
    rng = np.random.default_rng(21)
    img = rng.standard_normal((n, c, h, w)).astype(np.float32)
    grids = _grids(n, ho, wo)
    grids["boundary"] = _boundary_grid(n, ho, wo, h, w)
    vjp = jax.jit(lambda i, gr, ct: jax.vjp(
        lambda a, b: grid_sample_pallas(a, b, padding_mode, interpret=True), i, gr)[1](ct))
    for name, grid in grids.items():
        g = rng.standard_normal((n, c, ho, wo)).astype(np.float32)
        got = kgs.grid_sample_bwd_dimg_fixed(torch.from_numpy(grid), torch.from_numpy(g),
                                             img.shape, padding_mode)
        want = np.asarray(vjp(jnp.asarray(img), jnp.asarray(grid), jnp.asarray(g))[0])
        np.testing.assert_allclose(got.numpy(), want, **GS_GRAD, err_msg=name)


@pytest.mark.parametrize("padding_mode", MODES)
def test_fixed_dimg_within_1e6_of_float64(padding_mode):
    """Against the plain version in float64 (the same f32 weights, exact
    products and sums), plane by plane, with planes 2^40 apart in scale."""
    grid, g, size = _inputs(22)
    g[0, 1] *= 2.0 ** 40
    g[1, 2] *= 2.0 ** -40
    want = kgs.grid_sample_bwd_dimg_plain(grid, g.double(), size, padding_mode)
    got = kgs.grid_sample_bwd_dimg_fixed(grid, g, size, padding_mode)
    assert want.dtype == torch.float64 and got.dtype == torch.float32
    assert _plane_err(got, want) <= F64_TOL


def test_fixed_dimg_same_bits_in_any_pixel_order():
    """The output pixels in a random order (grid and g permuted alike):
    the same bits, where the plain f32 scatter need not give them."""
    grid, g, size = _inputs(23, spread=0.3)  # taps crowd: many pixels a tap
    perm = torch.from_numpy(np.random.default_rng(24).permutation(16 * 24))
    n, c = size[:2]
    pgrid = grid.reshape(n, -1, 2)[:, perm].reshape(grid.shape)
    pg = g.reshape(n, c, -1)[..., perm].reshape(g.shape)
    for mode in MODES:
        a = kgs.grid_sample_bwd_dimg_fixed(grid, g, size, mode)
        b = kgs.grid_sample_bwd_dimg_fixed(pgrid, pg, size, mode)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), mode


@pytest.mark.parametrize("max_abs", [float(np.finfo(np.float32).max),
                                     float(np.finfo(np.float32).smallest_subnormal),
                                     1.0, 3.0])
@pytest.mark.parametrize("count", [1, 2, 102400, 2**31 - 1])
def test_fixed_point_exponent_never_overflows(count, max_abs):
    """The largest possible sum of a word, 8 count (max_abs 2^k + 1/2), in
    exact arithmetic: under 2^63 with room for the flag bits, and the
    scale no coarser than it must be (count max_abs 2^(k+2) >= 2^59)."""
    k = kgs.fixed_point_exponent(count, max_abs)
    top = Fraction(max_abs) * Fraction(2) ** k
    assert count * top < 2 ** 59
    assert 8 * count * (top + Fraction(1, 2)) < 2 ** 63 - 7
    assert count * top * 4 >= 2 ** 59
    assert 2.0 ** k > 0 and math.isfinite(2.0 ** k)  # the scale is a normal double
    t = kgs.fixed_point_exponent(count, torch.tensor([max_abs], dtype=torch.float32))
    assert int(t) == k


def test_fixed_dimg_zero_and_non_finite_planes():
    """A plane of zeros gives zeros; +inf, -inf and NaN land where the
    plain version puts them (an infinity times a weight of 0 is NaN), and
    the finite pixels stay within 1e-6 of float64."""
    grid, g, size = _inputs(25)
    g[1, 0] = 0.0
    g[0, 0, 3, 4] = math.inf
    g[0, 0, 9, 2] = -math.inf
    g[0, 1, 5, 5] = math.nan
    g[1, 2, 0, :4] = torch.tensor([math.inf, -math.inf, math.inf, math.nan])
    grid[0, 3, 4] = torch.tensor([-1.0 + 1.0 / 32, 0.0])  # x on a pixel: taps of weight 0
    for mode in MODES:
        got = kgs.grid_sample_bwd_dimg_fixed(grid, g, size, mode)
        want = kgs.grid_sample_bwd_dimg_plain(grid, g.double(), size, mode)
        assert torch.equal(got[1, 0], torch.zeros_like(got[1, 0]))
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(test(got), test(want)), (mode, test.__name__)
        assert int(torch.isnan(got[0, 0]).sum()) >= 1  # inf x 0
        fin = torch.isfinite(want)
        err = (got.double() - want).abs().where(fin, 0.0).amax((2, 3))
        scale = want.abs().where(fin, 0.0).amax((2, 3)).clamp_min(1e-300)
        assert float((err / scale).max()) <= F64_TOL, mode
