"""The PyTorch port's augmentation (`data/augment.py`), `ops/crop.py` and
`ops/bicubic.py` against the JAX package, on the CPU.

The JAX module draws from JAX's RNG; these tests reproduce its draws from
the same keys (`_jax_draws`, the key splits of the JAX `augment`) and hand
them to the port, so both build the same deformation. The warps are held
against the JAX warp's jnp route, and at a small plane against its Pallas
route in interpret mode (`SAN_TPU_GRID_SAMPLE=pallas`). Tolerances: grids
atol 1e-6 (f32 rounding of the affine sums and of the bicubic weights);
warped images atol 1e-5 of values in [0, 1] (F32_ATOL, the grid sample's
bar); crops exact. Inputs from numpy seeds.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.data import augment as jaug
from spatialalignmentnetwork_tpu.ops.bicubic import bicubic_resize2d as jbicubic
from spatialalignmentnetwork_tpu.ops.crop import center_crop as jcrop

from spatialalignmentnetwork_tpu_torch.data import augment as taug
from spatialalignmentnetwork_tpu_torch.ops.bicubic import bicubic_resize2d
from spatialalignmentnetwork_tpu_torch.ops.crop import center_crop
from spatialalignmentnetwork_tpu_torch.ops.grid_sample import warp

torch.set_num_threads(2)
GRID_ATOL = 1e-6
IMG_ATOL = 1e-5
POLICIES = ("None", "Rigid", "BSpline", "PBSpline")


def _images(seed, n=2, size=24):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 1, size, size)) + 1j * rng.random((n, 1, size, size))).astype(
        np.complex64)


def _jax_draws(key, n, bspline=True):
    """The draws the JAX `augment(x, key)` makes, as the port takes them."""
    k1, k2 = jax.random.split(key)
    k_r, k_t = jax.random.split(k1)
    rot, shift = taug.ROTATION, taug.TRANSLATION
    out = {"r": jax.random.uniform(k_r, (n,), minval=-rot, maxval=rot),
           "t": jax.random.uniform(k_t, (n,), minval=-shift, maxval=shift)}
    if bspline:
        out["ctrl"] = (jax.random.uniform(k2, (n, 2, 9, 9)) - 0.5) * 2 / taug.CONTROL_SCALE
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _policy_draws(policy, key, n, count):
    """The draws the JAX `augment_batch(policy, [count modalities], key)`
    makes."""
    if policy == "PBSpline":
        return _jax_draws(key, n)
    keys = jax.random.split(key, count)
    return [_jax_draws(k, n, policy == "BSpline") for k in keys]


@pytest.mark.parametrize("shape", [(20, 20), (21, 17), (30, 31), (33, 26), (24, 30)])
def test_center_crop_matches_jax(shape):
    """Crop and pad, odd and even, per axis (the odd pixel trailing), on
    numpy arrays and on tensors, real and complex."""
    x = _images(0, size=24)[:, 0]  # [2, 24, 24] complex
    x = x[:, :, :23]  # 24 x 23: odd along one axis
    want = jcrop(x, shape)
    got_np = center_crop(x, shape)
    assert isinstance(got_np, np.ndarray) and got_np.dtype == x.dtype
    np.testing.assert_array_equal(got_np, want)
    got_t = center_crop(torch.from_numpy(x), shape)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jcrop(jnp.asarray(x.real), shape)),
                                  center_crop(torch.from_numpy(x.real), shape).numpy())


@pytest.mark.parametrize("out_hw", [(352, 352), (16, 20), (5, 7)])
def test_bicubic_resize_matches_jax(out_hw):
    """Up and down, to the JAX matmul copy of torch's bicubic (itself held
    to torch in tests/test_torch_parity.py)."""
    x = np.random.default_rng(1).standard_normal((2, 2, 9, 9)).astype(np.float32)
    want = np.asarray(jbicubic(jnp.asarray(x), *out_hw))
    got = bicubic_resize2d(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=GRID_ATOL * float(np.abs(x).max()))


def test_grids_from_jax_draws_match_jax():
    """rigid_grid, bspline_grid and their sum from JAX's own draws, against
    the JAX functions on the same keys, at the 352 plane augmentation
    warps."""
    key = jax.random.PRNGKey(3)
    shape = (3, 1, 352, 352)
    d = _jax_draws(key, 3)
    k1, k2 = jax.random.split(key)
    np.testing.assert_allclose(taug.rigid_grid(d["r"], d["t"], shape).numpy(),
                               np.asarray(jaug.rigid_grid(k1, shape)), atol=GRID_ATOL)
    np.testing.assert_allclose(taug.bspline_grid(d["ctrl"], shape).numpy(),
                               np.asarray(jaug.bspline_grid(k2, shape)), atol=GRID_ATOL)
    _, want = jaug.augment(jnp.asarray(_images(2, 3, 352)), key)
    np.testing.assert_allclose(taug.deformation(d, shape).numpy(), np.asarray(want),
                               atol=GRID_ATOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_augment_batch_matches_jax(policy):
    """Both modalities through each policy from JAX's draws, against the
    JAX augment_batch on its jnp route, complex images."""
    key = jax.random.PRNGKey(4)
    batch = [_images(5, 2, 40), _images(6, 2, 40)]
    want = jaug.augment_batch(policy, [jnp.asarray(x) for x in batch], key)
    draws = None if policy == "None" else _policy_draws(policy, key, 2, len(batch))
    got = taug.augment_batch(policy, [torch.from_numpy(x) for x in batch], draws)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=IMG_ATOL)


def test_pbspline_shares_one_grid():
    """PBSpline warps every modality by the grid of its one draw; a seeded
    generator's draws repeat and stay within their ranges; Rigid builds
    the rigid part of its draws alone."""
    batch = [torch.from_numpy(_images(7, 2, 24)), torch.from_numpy(_images(8, 2, 24))]
    draws = taug.draw(torch.Generator().manual_seed(11), 2, "cpu")
    got = taug.augment_batch("PBSpline", batch, draws)
    _, grid = taug.augment(batch[0], draws)
    for g, x in zip(got, batch):
        torch.testing.assert_close(g, warp(x, grid, padding_mode="reflection"),
                                   rtol=0, atol=0)
    again = taug.augment_batch("PBSpline", batch,
                               taug.draw(torch.Generator().manual_seed(11), 2, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    rigid = taug.augment_batch("Rigid", batch, [draws, draws])
    want = taug.augment(batch[1], {"r": draws["r"], "t": draws["t"]})[0]
    torch.testing.assert_close(rigid[1], want, rtol=0, atol=0)
    d = taug.draw(torch.Generator().manual_seed(12), 1000, "cpu")
    assert float(d["r"].abs().max()) <= taug.ROTATION
    assert float(d["t"].abs().max()) <= taug.TRANSLATION
    assert float(d["ctrl"].abs().max()) <= 1.0 / taug.CONTROL_SCALE
    assert float(d["ctrl"].abs().max()) > 0.9 / taug.CONTROL_SCALE
    with pytest.raises(ValueError, match="policy"):
        taug.augment_batch("Affine", batch, draws)


@pytest.mark.parametrize("policy", ["Rigid", "PBSpline"])
def test_augment_matches_jax_pallas_route(monkeypatch, policy):
    """At a 16 x 16 plane, against the JAX warp's Pallas kernel in
    interpret mode (the tent the port's kernels follow)."""
    monkeypatch.setenv("SAN_TPU_GRID_SAMPLE", "pallas")
    key = jax.random.PRNGKey(9)
    batch = [_images(10, 2, 16), _images(11, 2, 16)]
    want = jaug.augment_batch(policy, [jnp.asarray(x) for x in batch], key)
    got = taug.augment_batch(policy, [torch.from_numpy(x) for x in batch],
                             _policy_draws(policy, key, 2, len(batch)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=IMG_ATOL)


def test_scaled_deformation_matches_jax():
    key = jax.random.PRNGKey(13)
    img = _images(14, 2, 32)
    for factor in (0.0, 0.5, 2.0):
        want = jaug.scaled_deformation(key, jnp.asarray(img), factor)
        got = taug.scaled_deformation(torch.from_numpy(img), factor, _jax_draws(key, 2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IMG_ATOL)
