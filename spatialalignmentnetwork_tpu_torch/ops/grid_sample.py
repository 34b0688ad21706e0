"""Bilinear grid sampling and affine grid generation (counterpart of the JAX
package's `ops/grid_sample.py`).

  * affine_grid(theta, size): normalized sampling grid [N, H, W, 2] with
    grid[..., 0] = x (width axis), grid[..., 1] = y; align_corners=False.
  * grid_sample(input, grid, padding_mode): bilinear sampling; out-of-bounds
    reads are zero (zeros), edge-clamped (border) or edge-reflected
    (reflection). Differentiable in the image and the grid through the
    custom op `san::grid_sample_fwd` of `kernels/grid_sample.py` and its
    registered backward: on CUDA tensors the CUDA
    kernels run forward and backward, on CPU tensors their plain versions.
"""

import torch

from ..kernels.grid_sample import grid_sample_fwd


def _base_coords_1d(n: int, dtype, device) -> torch.Tensor:
    """Normalized coords of pixel centers with align_corners=False:
    x_i = (2i + 1)/n - 1."""
    i = torch.arange(n, dtype=dtype, device=device)
    return (2.0 * i + 1.0) / n - 1.0


def affine_grid(theta: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """theta: [N, 2, 3]; size: (N, C, H, W) -> grid [N, H, W, 2]."""
    if align_corners:
        raise NotImplementedError("only align_corners=False is supported")
    n, _, h, w = size
    dtype, device = theta.dtype, theta.device
    xs = _base_coords_1d(w, dtype, device)
    ys = _base_coords_1d(h, dtype, device)
    base = torch.stack(
        [
            xs[None, :].expand(h, w),
            ys[:, None].expand(h, w),
            torch.ones((h, w), dtype=dtype, device=device),
        ],
        dim=-1,
    )  # [H, W, 3]
    # elementwise products summed in order: exact f32 for the identity,
    # whatever the matmul precision settings of the device
    grid = (theta[:, None, None, :, :] * base[None, :, :, None, :]).sum(-1)
    if n > 1 and grid.shape[0] == 1:
        grid = grid.expand(n, h, w, 2)
    return grid


def identity_grid(size, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Identity affine grid [1, H, W, 2] for (N, C, H, W)."""
    theta = torch.tensor(
        [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], dtype=dtype, device=device
    )
    return affine_grid(theta, (1, *size[1:]))


def grid_sample(
    input: torch.Tensor,
    grid: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Bilinear sample `input` [N,C,H,W] at `grid` [N,Ho,Wo,2] -> [N,C,Ho,Wo].

    Complex input samples its real and imaginary planes separately. The
    grid is read in f32 whatever the image type.
    """
    if align_corners:
        raise NotImplementedError("only align_corners=False is supported")
    if input.is_complex():
        re = grid_sample(input.real.contiguous(), grid, padding_mode)
        im = grid_sample(input.imag.contiguous(), grid, padding_mode)
        return torch.complex(re, im)
    if not input.is_floating_point():
        raise TypeError(
            f"grid_sample needs a float (or complex) image, got {input.dtype}"
        )
    return grid_sample_fwd(input, grid.to(torch.float32), padding_mode)


def warp(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros") -> torch.Tensor:
    """Warp an image (real or complex) by a sampling grid; a complex image
    packs real and imaginary parts as channels for one sampler pass."""
    if img.is_complex():
        c = img.shape[1]
        packed = torch.cat([img.real, img.imag], dim=1)
        out = grid_sample(packed, grid, padding_mode)
        return torch.complex(out[:, :c], out[:, c:])
    return grid_sample(img, grid, padding_mode)
