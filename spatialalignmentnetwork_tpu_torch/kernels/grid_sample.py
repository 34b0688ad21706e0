"""Bilinear grid sample, forward and backward: the CUDA kernels of
`csrc/grid_sample.cu`, their plain PyTorch versions, and the custom op
with its registered backward that joins them.

Replaces the Pallas TPU kernels of the JAX package's
`ops/pallas/grid_sample.py`: `_forward` / `_kernel` (pallas_call at :222)
and the custom VJP's `_bwd`, `_kernel_dimg` (call :438) and
`_kernel_dgrid` (call :451). Bound on the H100 by memory: see the note at
the top of the CUDA source.

`grid_sample_fwd(img, grid, padding_mode)` takes img [N, C, H, W] (f32,
or bf16 without a gradient) and grid [N, Ho, Wo, 2] f32 (x first,
normalized to [-1, 1], align_corners=False) and returns [N, C, Ho, Wo] in
the image type. It calls the custom op `san::grid_sample_fwd`
(`grid_sample_op`), whose fake implementation lets torch.export and
FakeTensorMode trace it without touching a pointer, and whose registered
backward gives d_grid when the grid needs a gradient and d_img when the
image does. Each piece takes the kernel on CUDA tensors and the plain
version on CPU tensors (`kernels.on_card`), so one code path serves both
devices.

The backward follows JAX's autodiff of the JAX package's grid sample:
floor-form tap derivatives, a tap outside the image reading 0 (as the
Pallas tent does), and half the gradient at an exact clamp bound of the
border/reflection transform. The d_img kernel sums in fixed point, so its
bits do not depend on the order of its atomics:
`grid_sample_bwd_dimg_fixed` is its arithmetic in torch, and
`fixed_point_exponent` its choice of scale.
"""

import ctypes
import functools
import math

import torch

from . import launch, load, on_card

NAME = "grid_sample_fwd"
DGRID = "grid_sample_bwd_dgrid"
DIMG = "grid_sample_bwd_dimg"
SOURCE = "grid_sample.cu"
PADDING_MODES = {"zeros": 0, "border": 1, "reflection": 2}
_TAPS = ((0, 0), (1, 0), (0, 1), (1, 1))  # (dx, dy), the kernels' order
DIMG_TILE = 32  # the d_img kernel's output tile, DIMG_TILE x DIMG_TILE (kDimgTile)
HEADROOM_BITS = 59  # a d_img plane's sum stays under 2^59 before the flag bits
_POS_INF, _NEG_INF, _NAN = 1, 2, 4  # the flags in a d_img word's low three bits


# ------------------------------------------------------------ plain versions
def _unnormalize(g: torch.Tensor, size: int) -> torch.Tensor:
    return ((g + 1.0) * size - 1.0) / 2.0


def _reflect_unclamped(x: torch.Tensor, size: int):
    """Reflect about the pixel-edge bounds [-0.5, size - 0.5]
    (align_corners=False); returns the reflected coordinate before the
    clamp and its slope d/dx (+-1).

    The JAX package takes the parity of floor(t / size); here it is read
    from fmod(t, 2 * size), which is exact and needs no division (a CUDA
    division by a scalar multiplies by its rounded reciprocal, which can
    flip the parity at t = k * size). Both give the same values."""
    low = -0.5
    span = float(size)
    d = x - low
    m = torch.fmod(torch.abs(d), 2.0 * span)  # |d| >= 0: fmod is the floor-mod
    even = m < span
    out = torch.where(even, m + low, span - (m - span) + low)
    slope = torch.where((d >= 0) == even, 1.0, -1.0)  # JAX: abs'(0) = +1
    return out, slope


def _clamp_slope(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d/dx min(max(x, lo), hi) as JAX differentiates jnp.clip: a max or
    min tie splits the gradient evenly, so an exact bound gives 0.5
    (torch.clamp gives 1 there)."""
    d_max = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    a = torch.clamp_min(x, lo)
    d_min = torch.where(a < hi, 1.0, torch.where(a == hi, 0.5, 0.0))
    return d_max * d_min


def _pad(x: torch.Tensor, size: int, padding_mode: str) -> torch.Tensor:
    """The padding transform of the sampled pixel coordinate."""
    if padding_mode == "reflection":
        x = _reflect_unclamped(x, size)[0]
    if padding_mode in ("reflection", "border"):
        x = torch.clamp(x, 0.0, size - 1.0)
    return x


def _pad_slope(x: torch.Tensor, size: int, padding_mode: str) -> torch.Tensor:
    """d _pad(x) / dx with JAX's tie rule (a power of two times -1, 0, 1)."""
    if padding_mode == "reflection":
        out, slope = _reflect_unclamped(x, size)
        return slope * _clamp_slope(out, 0.0, size - 1.0)
    if padding_mode == "border":
        return _clamp_slope(x, 0.0, size - 1.0)
    return torch.ones_like(x)


def _taps(grid: torch.Tensor, h: int, w: int, padding_mode: str):
    """Per tap (in _TAPS order): bilinear weight, inside-the-image mask and
    plane index (clamped into the image); plus the fractional parts and the
    unnormalized coordinates. The forward's f32 coordinate arithmetic."""
    ux = _unnormalize(grid[..., 0].to(torch.float32), w)
    uy = _unnormalize(grid[..., 1].to(torch.float32), h)
    ix = _pad(ux, w, padding_mode)
    iy = _pad(uy, h, padding_mode)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    taps = []
    for dx, dy in _TAPS:
        xc = x0 + dx
        yc = y0 + dy
        weight = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
        inside = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        xi = torch.clamp(xc, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yc, 0, h - 1).to(torch.int64)
        taps.append((weight, inside, yi * w + xi))
    return taps, wx, wy, ux, uy


def _gather(flat: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """flat [N, C, H*W] at index [N, Ho, Wo] -> [N, C, Ho, Wo]."""
    n, c, _ = flat.shape
    idx = index.reshape(n, 1, -1).expand(n, c, -1)
    return torch.gather(flat, 2, idx).reshape(n, c, *index.shape[1:])


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor,
                      padding_mode: str = "zeros") -> torch.Tensor:
    """The 4-tap gather of the JAX package's ops/grid_sample.py:115-167,
    in torch: f32 coordinates and accumulation, output in the image type.
    Differentiable through torch.gather (with torch.clamp's tie rule)."""
    n, c, h, w = img.shape
    flat = img.to(torch.float32).reshape(n, c, h * w)
    taps, *_ = _taps(grid, h, w, padding_mode)
    out = None
    for weight, inside, index in taps:
        if padding_mode == "zeros":
            weight = torch.where(inside, weight, 0.0)
        term = _gather(flat, index) * weight[:, None]
        out = term if out is None else out + term
    return out.to(img.dtype)


def grid_sample_bwd_dgrid_plain(img: torch.Tensor, grid: torch.Tensor,
                                gout: torch.Tensor,
                                padding_mode: str = "zeros") -> torch.Tensor:
    """d_grid [N, Ho, Wo, 2] f32 for the upstream gradient gout
    [N, C, Ho, Wo]: floor-form tap derivatives summed over C (a tap
    outside the image reads 0), chained through the padding transform and
    the unnormalization."""
    n, c, h, w = img.shape
    flat = img.to(torch.float32).reshape(n, c, h * w)
    taps, wx, wy, ux, uy = _taps(grid, h, w, padding_mode)
    v = [torch.where(inside[:, None], _gather(flat, index), 0.0)
         for _, inside, index in taps]
    wx = wx[:, None]
    wy = wy[:, None]
    ddx = (1.0 - wy) * (v[1] - v[0]) + wy * (v[3] - v[2])
    ddy = (1.0 - wx) * (v[2] - v[0]) + wx * (v[3] - v[1])
    g = gout.to(torch.float32)
    dix = (g * ddx).sum(1)
    diy = (g * ddy).sum(1)
    return torch.stack([dix * (_pad_slope(ux, w, padding_mode) * (0.5 * w)),
                        diy * (_pad_slope(uy, h, padding_mode) * (0.5 * h))], -1)


def grid_sample_bwd_dimg_plain(grid: torch.Tensor, gout: torch.Tensor,
                               size, padding_mode: str = "zeros") -> torch.Tensor:
    """d_img [N, C, H, W] (`size` is the image's shape): each output
    pixel's upstream gradient scattered onto its four taps, weighted, in
    f32 (float64 for a float64 `gout`: the same f32 weights, exact
    products)."""
    n, c, h, w = size
    taps, *_ = _taps(grid, h, w, padding_mode)
    g = gout.to(torch.promote_types(gout.dtype, torch.float32)).reshape(n, c, -1)
    dimg = torch.zeros((n, c, h * w), dtype=g.dtype, device=gout.device)
    for weight, inside, index in taps:
        weight = torch.where(inside, weight, 0.0).reshape(n, 1, -1)
        idx = index.reshape(n, 1, -1).expand(n, c, -1)
        dimg.scatter_add_(2, idx, g * weight)
    return dimg.reshape(n, c, h, w)


def fixed_point_exponent(count: int, max_abs):
    """The d_img kernel's scale 2^k for a plane of `count` output pixels
    whose largest finite |g| is `max_abs` (a float, or a tensor of them):
    k = HEADROOM_BITS - ceil(log2 count) - e, with max_abs = m 2^e, m in
    [0.5, 1) (e = 0 for 0), so that count max_abs 2^k < 2^59. Each output
    pixel adds g w (weight w <= 1) to a source pixel at most once, as 8
    round(g w 2^k); so a source pixel's sum stays within 8 count (max_abs
    2^k + 1/2) < 2^62 + 2^33, inside int64, and its low three bits stay
    free for the non-finite flags."""
    lg = (count - 1).bit_length()
    if isinstance(max_abs, torch.Tensor):
        e = torch.frexp(max_abs.to(torch.float64))[1].to(torch.int64)
    else:
        e = math.frexp(float(max_abs))[1]
    return HEADROOM_BITS - lg - e


def grid_sample_bwd_dimg_fixed(grid: torch.Tensor, gout: torch.Tensor, size,
                               padding_mode: str = "zeros") -> torch.Tensor:
    """d_img [N, C, H, W] f32 by the d_img kernel's arithmetic, in torch:
    per plane the scale of `fixed_point_exponent`, each tap's contribution
    8 round(g w 2^k) summed in int64 (`scatter_add_`, in any order: the
    same bits), the non-finite contributions' flags (+inf, -inf, NaN) in
    the low three bits, then f32(double(sum / 8) 2^-k) or the flagged
    value. Nothing on the port's paths calls it: it shows on the CPU what
    the kernel computes."""
    n, c, h, w = size
    count = grid.shape[1] * grid.shape[2]
    taps, *_ = _taps(grid, h, w, padding_mode)
    g = gout.to(torch.float32).reshape(n, c, -1)
    finite = torch.isfinite(g)
    g64 = torch.where(finite, g, 0.0).to(torch.float64)
    k = fixed_point_exponent(count, g64.abs().amax(-1, keepdim=True))
    scale = torch.ldexp(torch.ones_like(g64[..., :1]), k)
    words = torch.zeros((n, c, h * w), dtype=torch.int64, device=g.device)
    flags = {bit: torch.zeros_like(words) for bit in (_POS_INF, _NEG_INF, _NAN)}
    for weight, inside, index in taps:
        weight = torch.where(inside, weight, 0.0).reshape(n, 1, -1)
        idx = index.reshape(n, 1, -1).expand(n, c, -1)
        q = torch.round(g64 * weight.to(torch.float64) * scale).to(torch.int64)
        words.scatter_add_(2, idx, q * 8)
        flag = torch.where(torch.isnan(g) | (weight == 0), _NAN,
                           torch.where(g > 0, _POS_INF, _NEG_INF))
        for bit, acc in flags.items():
            acc.scatter_reduce_(2, idx, torch.where(~finite & (flag == bit), bit, 0)
                                .to(torch.int64), "amax")
    words |= flags[_POS_INF] | flags[_NEG_INF] | flags[_NAN]
    low = words & 7
    value = (torch.div(words, 8, rounding_mode="floor").to(torch.float64)
             * torch.ldexp(torch.ones_like(scale), -k)).to(torch.float32)
    value = torch.where(low == _POS_INF, math.inf, value)
    value = torch.where(low == _NEG_INF, -math.inf, value)
    value = torch.where(((low & _NAN) != 0) | (low == (_POS_INF | _NEG_INF)), math.nan, value)
    return value.reshape(n, c, h, w)


# ------------------------------------------------------------ CUDA wrappers
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


def _check_cuda(size, grid: torch.Tensor, *tensors: torch.Tensor):
    """What every launch needs: CUDA, contiguous, an aligned f32 grid,
    fewer than 2^31 elements per tensor."""
    for t in (grid, *tensors):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("grid_sample kernel inputs must be contiguous")
    if grid.dtype != torch.float32:
        raise TypeError(f"grid must be float32, got {grid.dtype}")
    if grid.data_ptr() % 8:
        raise ValueError("grid must be 8-byte aligned (float2 loads)")
    n, c, h, w = size
    _, ho, wo, _ = grid.shape
    if max(n * c * h * w, n * c * ho * wo, n * ho * wo * 2) >= 2**31:
        raise ValueError("grid_sample kernels take fewer than 2^31 elements")


def _check_gout(gout: torch.Tensor, size, grid: torch.Tensor):
    n, c = size[:2]
    if tuple(gout.shape) != (n, c, *grid.shape[1:3]):
        raise ValueError(f"upstream gradient {tuple(gout.shape)} does not "
                         f"match the output {(n, c, *grid.shape[1:3])}")
    if gout.dtype != torch.float32:
        raise TypeError(f"the backward kernels take float32, got {gout.dtype}")


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor,
                     padding_mode: str = "zeros") -> torch.Tensor:
    """Launch the forward kernel on the image's card and its current stream."""
    _check(img, grid, padding_mode)
    _check_cuda(img.shape, grid, img)
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image must be float32 or bfloat16, got {img.dtype}")
    n, c, h, w = img.shape
    _, ho, wo, _ = grid.shape
    out = torch.empty((n, c, ho, wo), dtype=img.dtype, device=img.device)
    launch(NAME, _launcher("san_grid_sample_fwd", 3, 8), img,
           img.data_ptr(), grid.data_ptr(), out.data_ptr(),
           n, c, h, w, ho, wo, PADDING_MODES[padding_mode],
           int(img.dtype == torch.bfloat16))
    return out


def grid_sample_bwd_dgrid_cuda(img: torch.Tensor, grid: torch.Tensor,
                               gout: torch.Tensor,
                               padding_mode: str = "zeros") -> torch.Tensor:
    """Launch the d_grid kernel; returns d_grid [N, Ho, Wo, 2] f32."""
    _check(img, grid, padding_mode)
    _check_cuda(img.shape, grid, img, gout)
    _check_gout(gout, img.shape, grid)
    if img.dtype != torch.float32:
        raise TypeError(f"the backward kernels take float32, got {img.dtype}")
    n, c, h, w = img.shape
    _, ho, wo, _ = grid.shape
    dgrid = torch.empty((n, ho, wo, 2), dtype=torch.float32, device=grid.device)
    launch(DGRID, _launcher("san_grid_sample_bwd_dgrid", 4, 7), grid,
           img.data_ptr(), grid.data_ptr(), gout.data_ptr(), dgrid.data_ptr(),
           n, c, h, w, ho, wo, PADDING_MODES[padding_mode])
    return dgrid


def dimg_scratch_words(size, ho: int, wo: int) -> int:
    """int64 words of the d_img kernel's scratch: per plane its H W sums,
    a largest |g| a DIMG_TILE x DIMG_TILE output tile and its scale."""
    n, c, h, w = size
    tiles = -(-ho // DIMG_TILE) * -(-wo // DIMG_TILE)
    return n * c * (h * w + tiles + 1)


def grid_sample_bwd_dimg_cuda(grid: torch.Tensor, gout: torch.Tensor, size,
                              padding_mode: str = "zeros") -> torch.Tensor:
    """Launch the d_img kernel; returns d_img [N, C, H, W] f32 (`size`),
    the same bits on every run (see `grid_sample_bwd_dimg_fixed`). The
    kernel writes every element and zeroes its own int64 scratch."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    size = tuple(size)
    _check_cuda(size, grid, gout)
    _check_gout(gout, size, grid)
    n, c, h, w = size
    _, ho, wo, _ = grid.shape
    dimg = torch.empty(size, dtype=torch.float32, device=grid.device)
    scratch = torch.empty(dimg_scratch_words(size, ho, wo), dtype=torch.int64,
                          device=grid.device)
    launch(DIMG, _launcher("san_grid_sample_bwd_dimg", 4, 7), grid,
           grid.data_ptr(), gout.data_ptr(), dimg.data_ptr(), scratch.data_ptr(),
           n, c, h, w, ho, wo, PADDING_MODES[padding_mode])
    return dimg


@functools.cache
def _launcher(symbol: str, n_ptrs: int, n_ints: int):
    fn = getattr(load(SOURCE), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ custom op
@torch.library.custom_op("san::grid_sample_fwd", mutates_args=())
def grid_sample_op(img: torch.Tensor, grid: torch.Tensor,
                   padding_mode: str) -> torch.Tensor:
    """The forward as a torch.library op: the kernel on CUDA tensors, the
    plain version on CPU tensors. Tracing (torch.export, FakeTensorMode)
    reaches `_fake` instead and records the op as one node, so an exported
    program launches the same kernel when it replays on the card."""
    fwd = grid_sample_cuda if on_card(img) else grid_sample_plain
    return fwd(img, grid, padding_mode)


@grid_sample_op.register_fake
def _fake(img, grid, padding_mode):
    """The output's shape and type from the inputs' metadata alone."""
    n, c = img.shape[:2]
    return img.new_empty((n, c, grid.shape[1], grid.shape[2]))


def _setup_context(ctx, inputs, output):
    img, grid, padding_mode = inputs
    ctx.padding_mode = padding_mode
    ctx.save_for_backward(img, grid)


def _backward(ctx, gout):
    """The custom VJP of the JAX package's Pallas kernel: d_grid when the
    grid needs a gradient, d_img when the image does; kernels on CUDA
    tensors, plain versions on CPU tensors."""
    img, grid = ctx.saved_tensors
    gout = gout.contiguous()
    card = on_card(img)
    d_img = d_grid = None
    if ctx.needs_input_grad[1]:
        dgrid = grid_sample_bwd_dgrid_cuda if card else grid_sample_bwd_dgrid_plain
        d_grid = dgrid(img, grid, gout, ctx.padding_mode)
    if ctx.needs_input_grad[0]:
        dimg = grid_sample_bwd_dimg_cuda if card else grid_sample_bwd_dimg_plain
        d_img = dimg(grid, gout, img.shape, ctx.padding_mode).to(img.dtype)
    return d_img, d_grid, None


grid_sample_op.register_autograd(_backward, setup_context=_setup_context)


def grid_sample_fwd(img: torch.Tensor, grid: torch.Tensor,
                    padding_mode: str = "zeros") -> torch.Tensor:
    """Differentiable grid sample through `grid_sample_op`: kernels on
    CUDA tensors, plain versions on CPU tensors."""
    _check(img, grid, padding_mode)
    on_card(img)  # any other device raises here, before the op records
    return grid_sample_op(img, grid, padding_mode)
