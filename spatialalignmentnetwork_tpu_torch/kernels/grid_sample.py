"""Bilinear grid sample forward: the CUDA kernel `csrc/grid_sample.cu` and
its plain PyTorch version.

Replaces the Pallas TPU kernel `_forward` / `_kernel` of the JAX package
(`ops/pallas/grid_sample.py`, pallas_call at :222). Bound on the H100 by
memory: see the note at the top of the CUDA source.

`grid_sample_fwd(img, grid, padding_mode)` takes img [N, C, H, W] (f32 or
bf16) and grid [N, Ho, Wo, 2] f32 (x first, normalized to [-1, 1],
align_corners=False) and returns [N, C, Ho, Wo] in the image type. A CPU
tensor goes through the plain version; a CUDA tensor launches the kernel
or raises.
"""

import ctypes
import functools

import torch

from . import LAUNCHES, load

NAME = "grid_sample_fwd"
SOURCE = "grid_sample.cu"
PADDING_MODES = {"zeros": 0, "border": 1, "reflection": 2}


def _reflect(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect about the pixel-edge bounds [-0.5, size - 0.5]
    (align_corners=False), then clamp into [0, size - 1].

    The JAX package takes the parity of floor(t / size); here it is read
    from fmod(t, 2 * size), which is exact and needs no division (a CUDA
    division by a scalar multiplies by its rounded reciprocal, which can
    flip the parity at t = k * size). Both give the same values."""
    low = -0.5
    span = float(size)
    t = torch.abs(x - low)
    m = torch.fmod(t, 2.0 * span)  # t >= 0: fmod is the floor-mod here
    out = torch.where(m < span, m + low, span - (m - span) + low)
    return torch.clamp(out, 0.0, size - 1.0)


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor,
                      padding_mode: str = "zeros") -> torch.Tensor:
    """The 4-tap gather of the JAX package's ops/grid_sample.py:115-167,
    in torch: f32 coordinates and accumulation, output in the image type."""
    n, c, h, w = img.shape
    imgf = img.to(torch.float32)
    x = grid[..., 0].to(torch.float32)
    y = grid[..., 1].to(torch.float32)
    ix = ((x + 1.0) * w - 1.0) / 2.0
    iy = ((y + 1.0) * h - 1.0) / 2.0
    if padding_mode == "reflection":
        ix = _reflect(ix, w)
        iy = _reflect(iy, h)
    elif padding_mode == "border":
        ix = torch.clamp(ix, 0.0, w - 1.0)
        iy = torch.clamp(iy, 0.0, h - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    flat = imgf.reshape(n, c, h * w)
    out = None
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xc = x0 + dx
        yc = y0 + dy
        weight = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
        if padding_mode == "zeros":
            valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            weight = torch.where(valid, weight, 0.0)
        xi = torch.clamp(xc, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yc, 0, h - 1).to(torch.int64)
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(n, c, *xi.shape[1:])
        term = vals * weight[:, None]
        out = term if out is None else out + term
    return out.to(img.dtype)


def _check(img: torch.Tensor, grid: torch.Tensor, padding_mode: str):
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if img.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2:
        raise ValueError(
            f"grid_sample expects img [N,C,H,W] and grid [N,Ho,Wo,2], got "
            f"{tuple(img.shape)} and {tuple(grid.shape)}"
        )
    if grid.shape[0] != img.shape[0]:
        raise ValueError("img and grid batch sizes differ")
    if img.device != grid.device:
        raise ValueError(f"img on {img.device}, grid on {grid.device}")


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    _check(img, grid, padding_mode)
    if img.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {img.device}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image must be float32 or bfloat16, got {img.dtype}")
    if grid.dtype != torch.float32:
        raise TypeError(f"grid must be float32, got {grid.dtype}")
    if not (img.is_contiguous() and grid.is_contiguous()):
        raise ValueError("img and grid must be contiguous")
    if grid.data_ptr() % 8:
        raise ValueError("grid must be 8-byte aligned (float2 loads)")
    n, c, h, w = img.shape
    _, ho, wo, _ = grid.shape
    if max(n * c * h * w, n * c * ho * wo, n * ho * wo * 2) >= 2**31:
        raise ValueError("grid_sample kernel takes fewer than 2^31 elements")
    out = torch.empty((n, c, ho, wo), dtype=img.dtype, device=img.device)
    launch = _launcher()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            img.data_ptr(), grid.data_ptr(), out.data_ptr(),
            n, c, h, w, ho, wo, PADDING_MODES[padding_mode],
            int(img.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"grid_sample kernel launch failed: cudaError {rc}")
    LAUNCHES[NAME] += 1
    return out


@functools.cache
def _launcher():
    fn = load(SOURCE).san_grid_sample_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def grid_sample_fwd(img: torch.Tensor, grid: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    _check(img, grid, padding_mode)
    if img.device.type == "cuda":
        return grid_sample_cuda(img, grid, padding_mode)
    if img.device.type == "cpu":
        return grid_sample_plain(img, grid, padding_mode)
    raise ValueError(f"grid_sample has no path for device {img.device}")
