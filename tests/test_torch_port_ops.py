"""The PyTorch port's signal ops against the JAX package, on the CPU.

fft2/ifft2/rss/shifts, the k-space masks (same seed -> same `pruned`),
and the plain grid_sample that stands beside the CUDA kernel: held
against the JAX gather (`impl="jnp"`), the Pallas kernel in interpret
mode, and torch's own `F.grid_sample`. Inputs come from numpy seeds.
Tolerance for f32 ops: atol 1e-5 (differences are f32 rounding order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from spatialalignmentnetwork_tpu.ops import fft as jfft
from spatialalignmentnetwork_tpu.ops import masks as jmasks
from spatialalignmentnetwork_tpu.engine import checkpoint as jckpt
from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.models.stn import gradient_loss as jgradient_loss
from spatialalignmentnetwork_tpu.ops.grid_sample import (
    affine_grid as jaffine_grid, grid_sample as jgrid_sample,
    identity_grid as jidentity_grid,
)
from spatialalignmentnetwork_tpu.ops.pallas.grid_sample import grid_sample_pallas

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine import checkpoint as tckpt
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.models.stn import gradient_loss
from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs
from spatialalignmentnetwork_tpu_torch.ops import fft as tfft
from spatialalignmentnetwork_tpu_torch.ops import masks as tmasks
from spatialalignmentnetwork_tpu_torch.ops.grid_sample import (
    affine_grid, grid_sample, identity_grid, warp,
)

torch.set_num_threads(2)
ATOL = 1e-5


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def test_fft_rss_shift_match_jax():
    x = _complex(np.random.default_rng(0), (2, 3, 16, 24))
    xt = torch.from_numpy(x)
    for jf, tf in ((jfft.fft2, tfft.fft2), (jfft.ifft2, tfft.ifft2),
                   (jfft.fftshift2, tfft.fftshift2),
                   (jfft.ifftshift2, tfft.ifftshift2)):
        np.testing.assert_allclose(
            tf(xt).numpy(), np.asarray(jf(jnp.asarray(x))), atol=ATOL
        )
    np.testing.assert_allclose(
        tfft.rss(xt).numpy(), np.asarray(jfft.rss(jnp.asarray(x))), atol=ATOL
    )
    real = np.abs(x)
    real[0] = 0.0  # the zero guard
    np.testing.assert_allclose(
        tfft.rss(torch.from_numpy(real)).numpy(),
        np.asarray(jfft.rss(jnp.asarray(real))), atol=ATOL,
    )


@pytest.mark.parametrize("kind", ["standard", "equispaced", "lowpass", "mask", "taylor"])
def test_make_mask_same_pruned_for_same_seed(kind):
    for shape, sparsity in ((16, 0.25), (320, 0.25), (320, 0.125)):
        for seed in (0, 1, 7):
            j = jmasks.make_mask(kind, shape, sparsity, seed=seed)
            t = tmasks.make_mask(kind, shape, sparsity, seed=seed)
            np.testing.assert_array_equal(t.pruned, j.pruned)
            assert (t.weight is None) == (j.weight is None)
            assert tmasks.center_len_for(sparsity, shape) == jmasks.center_len_for(
                sparsity, shape
            )


def test_apply_mask_matches_jax_and_loupe_build_refused():
    rng = np.random.default_rng(1)
    k = _complex(rng, (2, 1, 16, 16))
    pruned = rng.random(16) > 0.5
    got = tmasks.apply_mask(torch.from_numpy(k), torch.from_numpy(pruned))
    want = jmasks.apply_mask(jnp.asarray(k), jnp.asarray(pruned))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(NotImplementedError):
        tmasks.make_mask("loupe", 16, 0.25, seed=0)


def _boundary_grid(n, ho, wo, h, w):
    """Grids at exact edge values: +-1 (pixel-edge bounds), the first and
    last pixel centers, exact integer pixel coordinates and just outside."""
    special_x = np.array(
        [-1.0, 1.0, 0.0, -1.0 + 1.0 / w, 1.0 - 1.0 / w, -1.0 - 1.0 / w,
         1.0 + 1.0 / w, 3.0, -3.0, 2.0 / w, 0.5], np.float32)
    special_y = np.array(
        [-1.0, 1.0, 0.0, -1.0 + 1.0 / h, 1.0 - 1.0 / h, -1.0 - 1.0 / h,
         1.0 + 1.0 / h, 2.5, -2.5, 2.0 / h, -0.5], np.float32)
    rng = np.random.default_rng(3)
    gx = rng.choice(special_x, (n, ho, wo))
    gy = rng.choice(special_y, (n, ho, wo))
    return np.stack([gx, gy], -1).astype(np.float32)


def _grids(n, h, w):
    rng = np.random.default_rng(h * 100 + w)
    ident = np.asarray(jidentity_grid((n, 1, h, w)))
    return {
        "random": (rng.standard_normal((n, h, w, 2)) * 0.8).astype(np.float32),
        "out_of_range": (rng.standard_normal((n, h, w, 2)) * 2.5).astype(np.float32),
        "smooth": (ident + rng.standard_normal((n, h, w, 2)) * 0.05).astype(np.float32),
        "boundary": _boundary_grid(n, h, w, h, w),
    }


@pytest.mark.parametrize("hw", [(16, 16), (24, 32)])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_plain_grid_sample_matches_jax_gather_and_pallas(hw, padding_mode):
    h, w = hw
    n, c = 2, 3
    img = np.random.default_rng(5).standard_normal((n, c, h, w)).astype(np.float32)
    for name, grid in _grids(n, h, w).items():
        got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                          padding_mode).numpy()
        want_jnp = jgrid_sample(jnp.asarray(img), jnp.asarray(grid),
                                padding_mode, impl="jnp")
        np.testing.assert_allclose(got, np.asarray(want_jnp), atol=ATOL,
                                   err_msg=f"jnp {name}")
        want_pallas = grid_sample_pallas(jnp.asarray(img), jnp.asarray(grid),
                                         padding_mode, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want_pallas), atol=ATOL,
                                   err_msg=f"pallas {name}")
        lib = F.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                            mode="bilinear", padding_mode=padding_mode,
                            align_corners=False).numpy()
        np.testing.assert_allclose(got, lib, atol=ATOL, err_msg=f"F {name}")


def test_grid_sample_complex_split_warp_and_bf16():
    rng = np.random.default_rng(6)
    img = _complex(rng, (2, 2, 16, 16))
    grid = _grids(2, 16, 16)["smooth"]
    got = warp(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    want = jgrid_sample(jnp.asarray(img), jnp.asarray(grid), "zeros", impl="jnp")
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    # bf16 image: f32 coordinates and accumulation, one rounding at the end
    imgb = torch.from_numpy(img.real.copy()).to(torch.bfloat16)
    outb = grid_sample(imgb, torch.from_numpy(grid))
    assert outb.dtype == torch.bfloat16
    ref = grid_sample(imgb.float(), torch.from_numpy(grid)).to(torch.bfloat16)
    torch.testing.assert_close(outb, ref, rtol=0, atol=0)


def test_identity_grid_is_exact():
    got = identity_grid((2, 1, 24, 32)).numpy()
    want = np.asarray(jidentity_grid((2, 1, 24, 32)))
    np.testing.assert_array_equal(got, want)
    img = torch.from_numpy(
        np.random.default_rng(7).standard_normal((1, 1, 24, 32)).astype(np.float32)
    )
    # pixel centers (2i+1)/n - 1 do not round-trip exactly through f32
    np.testing.assert_allclose(
        grid_sample(img, identity_grid(img.shape).contiguous()).numpy(),
        img.numpy(), atol=ATOL,
    )


def test_affine_grid_and_gradient_loss_match_jax():
    rng = np.random.default_rng(8)
    theta = (np.eye(2, 3)[None] + rng.standard_normal((3, 2, 3)) * 0.2).astype(
        np.float32
    )
    np.testing.assert_allclose(
        affine_grid(torch.from_numpy(theta), (3, 1, 24, 32)).numpy(),
        np.asarray(jaffine_grid(jnp.asarray(theta), (3, 1, 24, 32))), atol=ATOL,
    )
    offset = rng.standard_normal((2, 16, 24, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(gradient_loss(torch.from_numpy(offset))),
        float(jgradient_loss(jnp.asarray(offset))), rtol=1e-6,
    )


def test_config_and_tree_helpers_match_jax(tmp_path):
    cfg = Config(shape=16, sparsity=0.25, net_T_layers=(4, 8), mask="equispaced")
    cfg.save(str(tmp_path / "port"))
    jcfg = JaxConfig().load(str(tmp_path / "port"))
    assert jcfg.to_dict() == Config().load(str(tmp_path / "port")).to_dict()
    assert list(jcfg.net_T_layers) == [4, 8] and "mask" in jcfg
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros(3)}}, "e": np.arange(4)}
    flat = tckpt.flatten_tree(tree)
    assert flat.keys() == jckpt.flatten_tree(tree).keys()
    back = tckpt.unflatten_tree(flat)
    np.testing.assert_array_equal(back["a"]["c"]["d"], tree["a"]["c"]["d"])
    assert back.keys() == jckpt.unflatten_tree(flat).keys()


def test_wrapper_routes_cpu_to_plain_and_checks_inputs():
    img = torch.zeros((1, 1, 8, 8))
    grid = torch.zeros((1, 8, 8, 2))
    kernels.reset_launches()
    kgs.grid_sample_fwd(img, grid)
    assert kernels.LAUNCHES[kgs.NAME] == 0  # the plain version is no launch
    with pytest.raises(ValueError):
        kgs.grid_sample_cuda(img, grid)  # CPU tensors never reach the kernel
    with pytest.raises(ValueError):
        kgs.grid_sample_fwd(img, torch.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError):
        kgs.grid_sample_fwd(img, grid, "wrap")
