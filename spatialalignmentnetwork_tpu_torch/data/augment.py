"""Synthetic misalignment augmentation (counterpart of the JAX package's
`data/augment.py`).

A per-sample random rigid transform (rotation U(+-0.005 * 2 pi),
translation U(+-0.05), the same shift on both axes) composed with a 9x9
random B-spline control grid (U(+-1/50)) bicubically upsampled to the
image size; the image is warped bilinearly with reflection padding (the
CUDA grid sample kernel on a card), a complex image as its real and
imaginary planes packed into one pass.

Each random function of the JAX module is split in two: a draw from an
explicit `torch.Generator` on the images' device (`draw`), and a build
from given draws (`rigid_grid`, `bspline_grid`, `deformation` and the
warps, which take draws alone). So a caller can hand this module and the
JAX package the same numbers. `augment_batch` applies the four batch
policies (None / Rigid / BSpline / PBSpline, where PBSpline deforms every
modality by one shared grid).
"""

import math

import torch

from ..ops.bicubic import bicubic_resize2d
from ..ops.grid_sample import affine_grid, identity_grid, warp

ROTATION = 2 * math.pi * 0.005
TRANSLATION = 0.05
CONTROL_POINTS = 9
CONTROL_SCALE = 50


def _uniform(gen, shape, low, high, device):
    return low + torch.rand(shape, generator=gen, device=device) * (high - low)


def rigid_grid(r, t, batch_shape):
    """The sampling grid [N, H, W, 2] of the rigid transforms M = T R, the
    shift t on both axes."""
    cos, sin = torch.cos(r), torch.sin(r)
    theta = torch.stack([torch.stack([cos, -sin, t], dim=-1),
                         torch.stack([sin, cos, t], dim=-1)], dim=1)  # [N, 2, 3]
    return affine_grid(theta, batch_shape)


def bspline_grid(ctrl, batch_shape):
    """Dense offsets [N, H, W, 2] (to add to a grid) from control points."""
    _, _, h, w = batch_shape
    return bicubic_resize2d(ctrl, h, w).permute(0, 2, 3, 1)


def draw(gen, n: int, device, bspline: bool = True) -> dict:
    """One deformation's draws for n samples: rotation angles "r" [n] and
    shifts "t" [n] and, with `bspline`, control-point offsets "ctrl"
    [n, 2, 9, 9], U(+-1 / CONTROL_SCALE)."""
    out = {"r": _uniform(gen, (n,), -ROTATION, ROTATION, device),
           "t": _uniform(gen, (n,), -TRANSLATION, TRANSLATION, device)}
    if bspline:
        shape = (n, 2, CONTROL_POINTS, CONTROL_POINTS)
        out["ctrl"] = _uniform(gen, shape, -1 / CONTROL_SCALE, 1 / CONTROL_SCALE, device)
    return out


def deformation(draws: dict, batch_shape):
    """The grid [N, H, W, 2] of `draws`: rigid, plus the B-spline offsets
    where the draws have control points."""
    grid = rigid_grid(draws["r"], draws["t"], batch_shape)
    if "ctrl" in draws:
        grid = grid + bspline_grid(draws["ctrl"], batch_shape)
    return grid


def _warp(img, grid):
    return warp(img, grid, padding_mode="reflection")


def augment(img, draws: dict):
    """Warp `img` [N, C, H, W] (real or complex) by the deformation of
    `draws`, reflection padding; returns (warped, grid)."""
    grid = deformation(draws, img.shape)
    return _warp(img, grid), grid


def augment_batch(policy: str, batch, draws=None):
    """Apply a named policy to a list of modality tensors [N, C, H, W]:
    "None" (no draws), "Rigid" or "BSpline" (`draws`: a list of one `draw`
    a modality; Rigid builds their rigid part alone), "PBSpline" (`draws`:
    one `draw`, whose rigid + B-spline grid deforms every modality)."""
    if policy == "None":
        return list(batch)
    if policy in ("Rigid", "BSpline"):
        if policy == "Rigid":
            draws = [{"r": d["r"], "t": d["t"]} for d in draws]
        return [augment(x, d)[0] for x, d in zip(batch, draws, strict=True)]
    if policy == "PBSpline":
        grid = deformation(draws, batch[0].shape)
        return [_warp(x, grid) for x in batch]
    raise ValueError(f"unknown augmentation policy: {policy!r}")


def scaled_deformation(img, factor: float, draws: dict):
    """Eval-time scaled misalignment: the rigid + B-spline grid of `draws`
    whose offset from the identity is scaled by `factor`, then the warp."""
    grid = deformation(draws, img.shape)
    identity = identity_grid(img.shape, grid.dtype, grid.device)
    return _warp(img, identity + (grid - identity) * factor)
