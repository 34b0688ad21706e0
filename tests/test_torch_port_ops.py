"""The PyTorch port's signal ops against the JAX package, on the CPU.

fft2/ifft2/rss/shifts, the k-space masks (same seed -> same `pruned`),
the plain grid_sample that stands beside the CUDA kernels, forward and
backward: held against the JAX gather (`impl="jnp"`), the Pallas kernel in
interpret mode (with its custom VJP), and torch's own `F.grid_sample`;
the window sums and the plain SSIM loss, forward and closed-form backward,
against the JAX package's and the Pallas kernel's. Inputs come from numpy
seeds. Tolerance for f32 ops: atol 1e-5 (differences are f32 rounding
order); gradients rtol 1e-4 with atol 1e-5 (grid sample) and 1e-6 (SSIM,
whose gradients are of order 1e-3).
"""

import os

import numpy as np
import pytest
import jax
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
from spatialalignmentnetwork_tpu.ops.pallas.ssim import ssimloss_pallas
from spatialalignmentnetwork_tpu.ops.ssim import ssim_map as jssim_map
from spatialalignmentnetwork_tpu.ops.window import window_sum2d as jwindow_sum2d

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine import checkpoint as tckpt
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.models.stn import gradient_loss
from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs
from spatialalignmentnetwork_tpu_torch.kernels import ssim as kssim
from spatialalignmentnetwork_tpu_torch.ops import fft as tfft
from spatialalignmentnetwork_tpu_torch.ops import masks as tmasks
from spatialalignmentnetwork_tpu_torch.ops.grid_sample import (
    affine_grid, grid_sample, identity_grid, warp,
)
from spatialalignmentnetwork_tpu_torch.ops.ssim import ssim_map, ssimloss
from spatialalignmentnetwork_tpu_torch.ops.window import window_sum2d

torch.set_num_threads(2)
ATOL = 1e-5
GS_GRAD = dict(rtol=1e-4, atol=1e-5)
SSIM_GRAD = dict(rtol=1e-4, atol=1e-6)
# the grad_fn torch.library gives `san::grid_sample_fwd`'s registered backward
OP_BACKWARD = "GeneratedBackwardFor_san_grid_sample_fwd_defaultBackward"


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


def test_apply_mask_matches_jax():
    rng = np.random.default_rng(1)
    k = _complex(rng, (2, 1, 16, 16))
    pruned = rng.random(16) > 0.5
    got = tmasks.apply_mask(torch.from_numpy(k), torch.from_numpy(pruned))
    want = jmasks.apply_mask(jnp.asarray(k), jnp.asarray(pruned))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


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


def _jax_vjp(fn, img, grid, g):
    """(d_img, d_grid) of fn(img, grid) for the cotangent g, jitted."""
    out = jax.jit(lambda i, gr, ct: jax.vjp(fn, i, gr)[1](ct))(
        jnp.asarray(img), jnp.asarray(grid), jnp.asarray(g))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("shapes", [((16, 16), (16, 16)), ((24, 32), (16, 24))])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_plain_grid_sample_backward_matches_jax(shapes, padding_mode):
    """d_img and d_grid of the plain versions against jax.vjp through the
    Pallas kernel (its custom VJP, interpreted) on every grid, and through
    the JAX gather except where the two JAX versions differ: at an exact
    upper-edge coordinate in border/reflection mode the gather reads the
    clamped tap where the Pallas tent (and the port) read 0."""
    (h, w), (ho, wo) = shapes
    n, c = 2, 3
    rng = np.random.default_rng(11)
    img = rng.standard_normal((n, c, h, w)).astype(np.float32)
    grids = _grids(n, ho, wo)
    grids["boundary"] = _boundary_grid(n, ho, wo, h, w)
    grids["identity"] = np.broadcast_to(
        np.asarray(jidentity_grid((n, 1, ho, wo))), (n, ho, wo, 2)).copy()
    vjps = {
        "pallas": jax.jit(lambda i, gr, ct: jax.vjp(
            lambda a, b: grid_sample_pallas(a, b, padding_mode, interpret=True),
            i, gr)[1](ct)),
        "jnp": jax.jit(lambda i, gr, ct: jax.vjp(
            lambda a, b: jgrid_sample(a, b, padding_mode, impl="jnp"), i, gr)[1](ct)),
    }
    for name, grid in grids.items():
        g = rng.standard_normal((n, c, ho, wo)).astype(np.float32)
        timg, tgrid, tg = map(torch.from_numpy, (img, grid, g))
        got = (kgs.grid_sample_bwd_dimg_plain(tgrid, tg, img.shape, padding_mode).numpy(),
               kgs.grid_sample_bwd_dgrid_plain(timg, tgrid, tg, padding_mode).numpy())
        impls = ["pallas"]
        if padding_mode == "zeros" or name not in ("boundary", "identity"):
            impls.append("jnp")
        for impl in impls:
            want = [np.asarray(a) for a in vjps[impl](
                jnp.asarray(img), jnp.asarray(grid), jnp.asarray(g))]
            for what, a, b in zip(("d_img", "d_grid"), got, want):
                np.testing.assert_allclose(a, b, **GS_GRAD,
                                           err_msg=f"{impl} {name} {what}")


def test_grid_sample_function_backward_equals_autograd_of_plain():
    """On CPU tensors the custom op runs the plain forward and the plain
    backward; away from clamp ties its gradients are torch's own autograd
    through the plain forward."""
    rng = np.random.default_rng(12)
    img = rng.standard_normal((2, 3, 16, 24)).astype(np.float32)
    g = rng.standard_normal((2, 3, 16, 24)).astype(np.float32)
    for mode in ("zeros", "border", "reflection"):
        for name in ("random", "out_of_range", "smooth"):
            grid = _grids(2, 16, 24)[name]
            grads = []
            for fn in (lambda i, gr: kgs.grid_sample_fwd(i, gr, mode),
                       lambda i, gr: kgs.grid_sample_plain(i, gr, mode)):
                i = torch.from_numpy(img).requires_grad_()
                gr = torch.from_numpy(grid).requires_grad_()
                out = fn(i, gr)
                grads.append(torch.autograd.grad(out, (i, gr), torch.from_numpy(g)))
                if len(grads) == 1:
                    assert out.grad_fn.name() == OP_BACKWARD
            for a, b in zip(*grads):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **GS_GRAD,
                                           err_msg=f"{mode} {name}")


@pytest.mark.parametrize("needs", [("img", "grid"), ("img",), ("grid",)])
def test_mocked_cuda_route_keeps_the_gradient(monkeypatch, needs):
    """The card's route through the custom op: with the launchers standing
    in for the kernels, the output has the op's registered backward as its
    grad_fn (a ctypes-filled tensor alone would have none), and backward
    runs the d_grid launcher only where the grid needs a gradient and the
    d_img launcher only where the image does (the STN-frozen None regime
    takes no d_grid)."""
    calls = []

    def standin(name, fn):
        def run(*args):
            calls.append(name)
            return fn(*args)
        return run

    monkeypatch.setattr(kgs, "on_card", lambda t: True)
    monkeypatch.setattr(kgs, "grid_sample_cuda", standin("fwd", kgs.grid_sample_plain))
    monkeypatch.setattr(kgs, "grid_sample_bwd_dgrid_cuda",
                        standin("dgrid", kgs.grid_sample_bwd_dgrid_plain))
    monkeypatch.setattr(kgs, "grid_sample_bwd_dimg_cuda",
                        standin("dimg", kgs.grid_sample_bwd_dimg_plain))
    rng = np.random.default_rng(13)
    img = torch.from_numpy(rng.random((2, 1, 16, 16)).astype(np.float32))
    grid = torch.from_numpy(_grids(2, 16, 16)["smooth"])
    img.requires_grad_("img" in needs)
    grid.requires_grad_("grid" in needs)
    out = warp(img, grid)
    assert out.grad_fn is not None
    assert out.grad_fn.name() == OP_BACKWARD
    out.square().sum().backward()
    assert calls == ["fwd"] + ["dgrid"] * ("grid" in needs) + ["dimg"] * ("img" in needs)
    i2 = img.detach().clone().requires_grad_("img" in needs)
    g2 = grid.detach().clone().requires_grad_("grid" in needs)
    kgs.grid_sample_plain(i2, g2).square().sum().backward()
    for mine, plain in ((img, i2), (grid, g2)):
        if mine.requires_grad:
            np.testing.assert_allclose(mine.grad.numpy(), plain.grad.numpy(), **GS_GRAD)
        else:
            assert mine.grad is None


@pytest.mark.parametrize("padding_mode", ["border", "reflection"])
def test_padding_tie_rule_on_identity_grid(padding_mode):
    """The identity grid lands exactly on the first and last pixel centres,
    the clamp bounds of border/reflection padding: there JAX's autodiff of
    jnp.clip gives half the gradient (torch.clamp would give all of it),
    and the port's d_grid follows JAX's."""
    n, c, h, w = 2, 3, 16, 16
    ident = np.broadcast_to(np.asarray(jidentity_grid((n, 1, h, w))), (n, h, w, 2)).copy()
    ix = ((ident[..., 0] + 1.0) * w - 1.0) / 2.0
    assert (ix == 0.0).any() and (ix == w - 1.0).any()  # exact ties
    rng = np.random.default_rng(14)
    img = rng.standard_normal((n, c, h, w)).astype(np.float32)
    g = rng.standard_normal((n, c, h, w)).astype(np.float32)
    tgrid = torch.from_numpy(ident).requires_grad_()
    out = grid_sample(torch.from_numpy(img), tgrid, padding_mode)
    (got,) = torch.autograd.grad(out, tgrid, torch.from_numpy(g))
    want = _jax_vjp(lambda i, gr: grid_sample_pallas(i, gr, padding_mode,
                                                     interpret=True), img, ident, g)[1]
    np.testing.assert_allclose(got.numpy(), want, **GS_GRAD)


@pytest.mark.parametrize("shape", [(2, 1, 16, 24), (3, 2, 13, 9), (1, 1, 7, 7)])
def test_plain_ssim_matches_pallas_and_jax(shape):
    rng = np.random.default_rng(15)
    X = rng.random(shape).astype(np.float32)
    Y = (X + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    loss, (gx, gy) = jax.value_and_grad(
        lambda a, b: ssimloss_pallas(a, b, interpret=True), (0, 1)
    )(jnp.asarray(X), jnp.asarray(Y))
    tX = torch.from_numpy(X).requires_grad_()
    tY = torch.from_numpy(Y).requires_grad_()
    got = ssimloss(tX, tY)
    assert got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(tX.grad.numpy(), np.asarray(gx), **SSIM_GRAD)
    np.testing.assert_allclose(tY.grad.numpy(), np.asarray(gy), **SSIM_GRAD)
    # the closed form against torch's autograd of the plain forward
    aX = torch.from_numpy(X).requires_grad_()
    aY = torch.from_numpy(Y).requires_grad_()
    n, c, h, w = shape
    (1 - kssim.ssim_fwd_plain(aX, aY).sum() / (n * c * (h - 6) * (w - 6))).backward()
    np.testing.assert_allclose(tX.grad.numpy(), aX.grad.numpy(), **SSIM_GRAD)
    np.testing.assert_allclose(tY.grad.numpy(), aY.grad.numpy(), **SSIM_GRAD)
    np.testing.assert_allclose(
        ssim_map(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
        np.asarray(jssim_map(jnp.asarray(X), jnp.asarray(Y))), atol=ATOL,
    )


def test_window_sum2d_matches_jax():
    x = np.random.default_rng(16).standard_normal((2, 3, 13, 10)).astype(np.float32)
    for padding in ("VALID", "SAME"):
        for win in (3, 7):
            np.testing.assert_allclose(
                window_sum2d(torch.from_numpy(x), win, padding).numpy(),
                np.asarray(jwindow_sum2d(jnp.asarray(x), win, padding)),
                atol=ATOL, err_msg=f"{padding} {win}",
            )
    with pytest.raises(ValueError):
        window_sum2d(torch.from_numpy(x), 3, "FULL")


def test_backward_and_ssim_wrappers_check_inputs():
    img = torch.zeros((1, 1, 8, 8))
    grid = torch.zeros((1, 8, 8, 2))
    with pytest.raises(ValueError):  # CPU tensors never reach a kernel
        kgs.grid_sample_bwd_dgrid_cuda(img, grid, img)
    with pytest.raises(ValueError):
        kgs.grid_sample_bwd_dimg_cuda(grid, img, img.shape)
    with pytest.raises(ValueError):
        kssim.ssim_fwd_cuda(img, img)
    with pytest.raises(ValueError):
        kssim.ssim_bwd_cuda(img, img, torch.ones(()))
    with pytest.raises(ValueError):  # planes smaller than the window
        ssimloss(torch.zeros((1, 1, 6, 8)), torch.zeros((1, 1, 6, 8)))
    with pytest.raises(TypeError):
        ssimloss(torch.zeros((1, 1, 8, 8), dtype=torch.complex64),
                 torch.zeros((1, 1, 8, 8), dtype=torch.complex64))
    kernels.reset_launches()
    ssimloss(torch.rand((1, 1, 8, 8)), torch.rand((1, 1, 8, 8)))
    assert kernels.LAUNCHES[kssim.FWD] == 0  # the plain version is no launch


# ------------------------------------------------------------ launch device
class _OnCard1(torch.Tensor):
    """A CPU tensor that claims to lie on cuda:1: the wrappers read its
    `.device`, the stand-ins below allocate their outputs on the CPU."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def card1(monkeypatch):
    """Stand-ins for a machine whose current device is 0: torch.cuda.device
    switches a recorded current device, each device's current stream is
    100 + its index, allocations on any device land on the CPU as
    `_OnCard1`, and every launcher of the five sources records (symbol,
    the current device at the launch, its arguments) and returns 0."""
    import types

    from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv
    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc
    from spatialalignmentnetwork_tpu_torch.kernels import mi as kmi

    current = [0]
    seen = []

    class Device:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    def allocator(real):
        def alloc(*shape, device=None, **kw):
            return real(*shape, **kw).as_subclass(_OnCard1)
        return alloc

    def launcher_of(mod):
        def get(*key):
            def run(*args):
                seen.append((key[0] if key else mod.SOURCE, current[0], args))
                return 0
            return run
        return get

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=100 + current[0]))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch, "empty", allocator(torch.empty))
    monkeypatch.setattr(torch, "zeros", allocator(torch.zeros))
    for mod in (kgs, kssim, klncc, kmi, kconv):
        monkeypatch.setattr(mod, "_launcher", launcher_of(mod))
    kernels.reset_launches()
    yield seen, lambda t: t.contiguous().as_subclass(_OnCard1)
    kernels.reset_launches()


def test_every_launch_runs_on_its_tensors_card(card1):
    """With tensors on cuda:1 while the current device is 0, every launch
    of grid_sample.cu, ssim.cu, lncc.cu, mi.cu and conv.cu runs inside
    torch.cuda.device(cuda:1), on cuda:1's current stream, so that a C
    entry point's per-device state (MI's SM count, the conv's and the
    fused backwards' shared-memory opt-in) is cuda:1's too."""
    from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv
    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc
    from spatialalignmentnetwork_tpu_torch.kernels import mi as kmi

    seen, on1 = card1
    rng = np.random.default_rng(16)
    img = on1(torch.from_numpy(rng.random((2, 1, 16, 16)).astype(np.float32)))
    grid = on1(torch.from_numpy(_grids(2, 16, 16)["smooth"]))
    g = on1(torch.ones(()))
    assert img.device == torch.device("cuda", 1)
    kgs.grid_sample_cuda(img, grid)
    kgs.grid_sample_bwd_dgrid_cuda(img, grid, img)
    kgs.grid_sample_bwd_dimg_cuda(grid, img, img.shape)
    kssim.ssim_fwd_cuda(img, img)
    kssim.ssim_bwd_cuda(img, img, g)
    klncc.lncc_fwd_cuda(img, img)
    klncc.lncc_bwd_cuda(img, img, g)
    stats = kmi.mi_fwd_cuda(img, img)[1]
    kmi.mi_bwd_cuda(img, img, stats, g)
    x = on1(torch.rand((2, 4, 4, 3)))
    kconv.conv3x3_cuda(x, on1(torch.rand((3, 3, 3, 2))))
    kconv.conv3x3_cuda(x.bfloat16(), on1(torch.rand((3, 3, 3, 2)).bfloat16()))
    assert [s for s, _, _ in seen] == [
        "san_grid_sample_fwd", "san_grid_sample_bwd_dgrid", "san_grid_sample_bwd_dimg",
        "san_ssim_fwd", "san_ssim_bwd", "san_lncc_fwd", "san_lncc_bwd",
        "san_mi_fwd", "san_mi_bwd", "conv.cu", "conv.cu"]
    for symbol, device, args in seen:
        assert device == 1, f"{symbol} launched on device {device}"
        assert args[-1] == 101, f"{symbol} on stream {args[-1]}"
    assert sum(kernels.LAUNCHES.values()) == len(seen)


@pytest.mark.parametrize("loss", ["ssim", "lncc"])
def test_fused_backwards_pass_no_scratch(card1, loss):
    """The fused backwards take no coefficient scratch: the C entry point
    gets I, J (X, Y), g, dI, dJ and the stream as its only pointers, as
    many arguments as its _ARGTYPES, in one launch."""
    import ctypes

    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc

    seen, on1 = card1
    mod = {"ssim": kssim, "lncc": klncc}[loss]
    rng = np.random.default_rng(17)
    x = on1(torch.from_numpy(rng.random((2, 1, 16, 12)).astype(np.float32)))
    y = on1(torch.from_numpy(rng.random((2, 1, 16, 12)).astype(np.float32)))
    g = on1(torch.ones(()))
    dx, dy = getattr(mod, f"{loss}_bwd_cuda")(x, y, g)
    ((symbol, _, args),) = seen
    types = mod._ARGTYPES[symbol]
    assert symbol == f"san_{loss}_bwd" and len(args) == len(types)
    ptrs = [a for a, t in zip(args, types) if t is ctypes.c_void_p]
    assert ptrs == [x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    dy.data_ptr(), 101]
    assert dict(kernels.LAUNCHES) == {mod.BWD: 1}


def _ssim_bwd_tiled(X, Y, gout, tile):
    """The fused CUDA backward's tiling, in torch: a tile of `tile` x `tile`
    pixels stages X and Y over itself plus 6 a side both ways (zeros
    outside the plane), takes the statistics of the (tile + 6)^2 windows
    whose top-left corners lie in [r0 - 6, r0 + tile) (rows, then columns,
    each in order), zeroes the G maps of windows outside the valid ones,
    box-scatters the four maps over its pixels and forms dX, dY."""
    n, c, h, w = X.shape
    k, NP = kssim.WIN, kssim.WIN * kssim.WIN
    S, C, cn = tile + 2 * (k - 1), tile + k - 1, NP / (NP - 1)
    C1, C2 = 0.01**2, 0.03**2
    edge = (k - 1, k - 1 + tile, k - 1, k - 1 + tile)
    Xp, Yp = F.pad(X, edge), F.pad(Y, edge)
    valid = torch.zeros_like(X)
    valid[..., :h - k + 1, :w - k + 1] = 1.0
    valid = F.pad(valid, edge)
    scale = 1.0 / (n * c * (h - k + 1) * (w - k + 1) * NP)
    s = -scale * gout
    dX, dY = torch.zeros_like(X), torch.zeros_like(Y)

    def in_order(v, m, dim):
        acc = v.narrow(dim, 0, m)
        for d in range(1, k):
            acc = acc + v.narrow(dim, d, m)
        return acc

    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            # staged (r, c) is pixel (r0 - 6 + r, c0 - 6 + c)
            x = Xp[..., r0:r0 + S, c0:c0 + S]
            y = Yp[..., r0:r0 + S, c0:c0 + S]
            ux, uy, uxx, uyy, uxy = (in_order(in_order(v, C, 3), C, 2) / NP
                                     for v in (x, y, x * x, y * y, x * y))
            A1 = 2 * ux * uy + C1
            A2 = 2 * cn * (uxy - ux * uy) + C2
            B1 = ux * ux + uy * uy + C1
            B2 = cn * (uxx - ux * ux) + cn * (uyy - uy * uy) + C2
            D = B1 * B2
            S_ = A1 * A2 / D
            sA1, sA2, sB1, sB2 = A2 / D, A1 / D, -S_ / B1, -S_ / B2
            G = (sA1 * 2 * uy + sA2 * (-2 * cn * uy) + sB1 * 2 * ux + sB2 * (-2 * cn * ux),
                 sA1 * 2 * ux + sA2 * (-2 * cn * ux) + sB1 * 2 * uy + sB2 * (-2 * cn * uy),
                 sA2 * 2 * cn, sB2 * cn)
            live = valid[..., r0:r0 + C, c0:c0 + C]  # window (i, j) at pixel (r0-6+i, c0-6+j)
            b = [in_order(in_order(g * live, tile, 3), tile, 2) for g in G]
            xt = x[..., k - 1:k - 1 + tile, k - 1:k - 1 + tile]
            yt = y[..., k - 1:k - 1 + tile, k - 1:k - 1 + tile]
            hh, ww = min(tile, h - r0), min(tile, w - c0)
            dX[..., r0:r0 + hh, c0:c0 + ww] = (s * (b[0] + 2 * xt * b[3] + yt * b[2]))[..., :hh, :ww]
            dY[..., r0:r0 + hh, c0:c0 + ww] = (s * (b[1] + 2 * yt * b[3] + xt * b[2]))[..., :hh, :ww]
    return dX, dY


@pytest.mark.parametrize("shape", [(2, 1, 45, 37), (1, 1, 7, 7), (1, 2, 64, 70),
                                   (1, 1, 38, 33)])
def test_ssim_fused_tiling_matches_the_plain_backward(shape):
    """The fused CUDA backward's tiles (kssim.TILE a side, the 6-pixel halo
    both ways, zero fill outside the plane, zero G maps outside the valid
    windows) give the plain closed form's dX, dY, in float64 to 1e-6 of
    max, on planes the tile does not divide and the smallest plane; the
    CUDA source's tile and window are these."""
    assert f"constexpr int kTile = {kssim.TILE};" in _csrc("window.cuh")
    assert f"constexpr int kWin = {kssim.WIN};" in _csrc("ssim.cu")
    rng = np.random.default_rng(18)
    X = torch.from_numpy(rng.random(shape))
    Y = X + 0.1 * torch.from_numpy(rng.standard_normal(shape))
    g = torch.tensor(0.7, dtype=torch.float64)
    got = _ssim_bwd_tiled(X, Y, g, kssim.TILE)
    want = kssim.ssim_bwd_plain(X, Y, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


def _csrc(name):
    return open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "spatialalignmentnetwork_tpu_torch", "csrc", name)).read()


def _ssim_s(Sx, Sy, Sxx, Syy, Sxy):
    """S of each window from its five window sums, as ssim.cu forms it."""
    NP = kssim.WIN * kssim.WIN
    cn, C1, C2 = NP / (NP - 1), 0.01**2, 0.03**2
    ux, uy, uxx, uyy, uxy = (v * (1.0 / NP) for v in (Sx, Sy, Sxx, Syy, Sxy))
    A1 = 2 * ux * uy + C1
    A2 = 2 * (cn * (uxy - ux * uy)) + C2
    B1 = ux * ux + uy * uy + C1
    B2 = cn * (uxx - ux * ux) + cn * (uyy - uy * uy) + C2
    return (A1 * A2) / (B1 * B2)


@pytest.mark.parametrize("shape", [(2, 1, 45, 37), (1, 1, 7, 7), (1, 2, 64, 70),
                                   (4, 1, 160, 160), (4, 1, 80, 80)])
def test_ssim_fwd_tiling_matches_the_plain_forward(shape):
    """The one-launch CUDA forward's tiles of windows (every tile height on
    the small planes, the tile rule's on 132 SMs at 160² and 80²; zeros
    beyond the plane, windows outside the valid ones dropped) and its
    reduction order (tests/test_torch_port_losses.py::_fwd_tiled) give the
    plain forward's per-plane sums, in float64 to 1e-12 relative."""
    from tests.test_torch_port_losses import _fwd_tiled

    n, c, h, w = shape
    k = kssim.WIN
    rule = {(4, 1, 160, 160): 32, (4, 1, 80, 80): 8}.get(shape)
    if rule:
        assert kernels.fwd_rows(n * c, h - k + 1, w - k + 1, 132) == rule
    rng = np.random.default_rng(19)
    X = torch.from_numpy(rng.random(shape))
    Y = X + 0.1 * torch.from_numpy(rng.standard_normal(shape))
    want = kssim.ssim_fwd_plain(X, Y)
    for rows in [rule] if rule else kernels.FWD_ROWS:
        got = _fwd_tiled(X, Y, k, rows, 0, h - k + 1, w - k + 1, _ssim_s)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=0,
                                   err_msg=f"{rows} rows")


@pytest.mark.parametrize("loss", ["ssim", "lncc"])
def test_forwards_are_one_launch_with_a_partial_a_tile(card1, monkeypatch, loss):
    """Each forward is one call of its C entry point, with as many
    arguments as its _ARGTYPES: the inputs, a scratch of one partial a
    tile and the sums as its pointers, and the tile's rows from
    kernels.fwd_rows, which sized the scratch (6 planes of 80 x 70
    outputs on 132 SMs: 16 rows, 5 x 3 tiles a plane)."""
    import ctypes

    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc

    seen, on1 = card1
    sizes = []
    stand_in = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *shape, **kw: sizes.append(
        (shape, kw.get("dtype"))) or stand_in(*shape, **kw))
    mod = {"ssim": kssim, "lncc": klncc}[loss]
    rng = np.random.default_rng(20)
    shape = (2, 3, 86, 76) if loss == "ssim" else (2, 3, 80, 70)  # 80 x 70 outputs
    x = on1(torch.from_numpy(rng.random(shape).astype(np.float32)))
    y = on1(torch.from_numpy(rng.random(shape).astype(np.float32)))
    sums = getattr(mod, f"{loss}_fwd_cuda")(x, y)
    ((symbol, _, args),) = seen
    types = mod._ARGTYPES[symbol]
    assert symbol == f"san_{loss}_fwd" and len(args) == len(types)
    ptrs = [a for a, t in zip(args, types) if t is ctypes.c_void_p]
    assert ptrs[:2] == [x.data_ptr(), y.data_ptr()] and ptrs[3:] == [sums.data_ptr(), 101]
    assert kernels.fwd_rows(6, 80, 70, 132) == 16 and args[-2] == 16
    assert sizes == [((6 * 5 * 3,), torch.float32), (((2, 3),), torch.float32)]
    assert sums.shape == (2, 3)
    assert dict(kernels.LAUNCHES) == {mod.FWD: 1}


def test_build_rehashes_when_a_header_changes(tmp_path, monkeypatch):
    """kernels.build names a library by its source and every header under
    csrc/: a library is reused while neither changes, and an edit of a
    header the source includes builds a new one. On a temporary csrc/,
    with a stand-in for the compiler (no nvcc is run)."""
    import types

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    calls = []

    def compile_stand_in(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="ptxas log", stderr="")

    monkeypatch.setattr(kernels.subprocess, "run", compile_stand_in)
    lib, log = kernels.build("k.cu")
    assert log == "ptxas log" and len(calls) == 1 and lib == kernels.library("k.cu")
    assert kernels.build("k.cu") == (lib, "") and len(calls) == 1  # reused
    (csrc / "shared.cuh").write_text("// two\n")
    lib2, log2 = kernels.build("k.cu")
    assert lib2 != lib and log2 == "ptxas log" and len(calls) == 2
    assert os.path.exists(lib) and os.path.exists(lib2)

