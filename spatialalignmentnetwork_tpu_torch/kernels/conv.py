"""3x3 stride-1 SAME convolution (NHWC, no bias) and its input gradient:
the CUDA kernel of `csrc/conv.cu`, its plain PyTorch version, and the
custom op with its registered backward that joins them.

Replaces the Pallas TPU kernel of the JAX package's `ops/pallas/conv.py`:
`_conv3x3_s2d` (:98, pallas_call at :117, body `_conv2x2_valid_kernel`
:67), with its custom VJP (:142-175). One C entry point, two kernels on
the tensor cores (warp-level mma.sync fed by cp.async, one scaffold): bf16
on m16n8k16, and f32 as 3xTF32 on m16n8k8 (each f32 operand split into a
TF32 high and low part, a product as three TF32 products, each exact in
f32, summed in f32 with round-to-nearest adds: it meets the f32 bar of
1e-5 of max against float64 that TF32 alone misses, as the CPU emulation
in tests/test_torch_port_conv.py shows). The f32 kernel is bound by
bytes where channels are few and elsewhere by its 3 x 2 M N K TF32
operations (495 TFLOP/s); the note at the top of the CUDA source has the
design and what bounds each kernel at the VarNet's shapes.

`conv3x3_s2d(x, w3)` takes x [N, H, W, Cin] (f32 or bf16, H and W even)
and w3 [3, 3, Cin, Cout] (HWIO, cast to x's dtype as the JAX kernel does)
and returns [N, H, W, Cout] in x's dtype, summed in f32. It calls the
custom op `san::conv3x3` (`conv3x3_op`), whose fake implementation lets
torch.export and FakeTensorMode trace it without touching a pointer. Its
input gradient is the same op again; its weight gradient is the library's
conv backward-filter, as JAX leaves it to XLA. Each piece takes the kernel
on CUDA tensors and the plain version on CPU tensors (`kernels.on_card`).
`models/layers.py::Conv3x3` routes the U-Nets' f32 3x3 convs through it.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ..ops.window import f32_convs
from . import launch, load, on_card

NAME = "conv3x3"
NAME_BF16 = "conv3x3_bf16"
SOURCE = "conv.cu"
DTYPES = (torch.float32, torch.bfloat16)  # what the kernel takes


# ------------------------------------------------------------ plain version
def check(x: torch.Tensor, w3: torch.Tensor):
    """Raise on what neither route takes."""
    if x.ndim != 4 or w3.ndim != 4 or tuple(w3.shape[:2]) != (3, 3) \
            or w3.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 expects x [N, H, W, Cin] and w3 [3, 3, Cin, "
                         f"Cout], got {tuple(x.shape)} and {tuple(w3.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"conv3x3_s2d needs even H and W, as the JAX kernel "
                         f"asserts (ops/pallas/conv.py:101), got {tuple(x.shape)}")
    if x.device != w3.device:
        raise ValueError(f"x on {x.device}, w3 on {w3.device}")


def conv3x3_plain(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """The nine shifted products x_pad[:, ky:ky+H, kx:kx+W, :] @ w3[ky, kx]
    of the zero-padded input, summed in f32 (in float64 for float64 x), w3
    first rounded to x's dtype; the result rounded once to x's dtype."""
    check(x, w3)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    w = w3.to(x.dtype).to(acc)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    _, h, wd, _ = x.shape
    out = None
    for ky in range(3):
        for kx in range(3):
            term = xp[:, ky:ky + h, kx:kx + wd, :] @ w[ky, kx]
            out = term if out is None else out + term
    return out.to(x.dtype)


def rotate(w3: torch.Tensor) -> torch.Tensor:
    """The weights of the input gradient: w3 rotated 180 degrees with its
    in and out channels swapped (ops/pallas/conv.py:160)."""
    return w3.flip(0, 1).transpose(2, 3).contiguous()


def weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW [3, 3, Cin, Cout] of sum(conv3x3(x, w) * g) for NHWC x and g: the
    library's convolution backward-filter in f32, cuDNN's TF32 off inside
    (the JAX VJP's XLA conv, ops/pallas/conv.py:162-171)."""
    with f32_convs():
        dw = torch.nn.grad.conv2d_weight(
            x.float().permute(0, 3, 1, 2), (g.shape[3], x.shape[3], 3, 3),
            g.float().permute(0, 3, 1, 2), padding=1)
    # an HWIO view of the OIHW result made contiguous (channels-last x and
    # g give a channels-last one): a route's weight, an HWIO view of an
    # OIHW parameter, then gets its gradient in the parameter's layout
    return dw.contiguous().permute(2, 3, 1, 0)


# ------------------------------------------------------------ CUDA wrapper
def conv3x3_cuda(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of x's dtype (f32: 3xTF32, bf16: bf16 mma): x
    [N, H, W, Cin] and w3 [3, 3, Cin, Cout], both contiguous f32 or both
    bf16 CUDA tensors; returns [N, H, W, Cout]."""
    check(x, w3)
    if x.dtype not in DTYPES or w3.dtype != x.dtype:
        raise TypeError(f"the conv3x3 kernel takes x and w3 both float32 or both "
                        f"bfloat16, got {x.dtype} and {w3.dtype}")
    if not (x.is_contiguous() and w3.is_contiguous()):
        raise ValueError("conv3x3 kernel inputs must be contiguous")
    if not on_card(x):
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    n, h, wd, cin = x.shape
    cout = w3.shape[3]
    if max(x.numel(), n * h * wd * cout, w3.numel()) >= 2**31:
        raise ValueError("the conv3x3 kernel takes fewer than 2^31 elements a tensor")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    launch(NAME_BF16 if bf16 else NAME, _launcher(), x,
           x.data_ptr(), w3.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, int(bf16))
    return out


@functools.cache
def _launcher():
    fn = load(SOURCE).san_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------ custom op
@torch.library.custom_op("san::conv3x3", mutates_args=())
def conv3x3_op(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """The forward as a torch.library op: the kernel on CUDA tensors, the
    plain version on CPU tensors; x and w3 of one dtype. Tracing
    (torch.export, FakeTensorMode) reaches `_fake` instead and records the
    op as one node, so an exported program launches the same kernel when
    it replays on the card."""
    fwd = conv3x3_cuda if on_card(x) else conv3x3_plain
    return fwd(x.contiguous(), w3.contiguous())


@conv3x3_op.register_fake
def _fake(x, w3):
    """The output's shape and type from the inputs' metadata alone."""
    check(x, w3)
    return x.new_empty((*x.shape[:3], w3.shape[3]))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    """The JAX custom VJP (ops/pallas/conv.py:151-172): the input gradient
    is the op again, on the rotated weights; the weight gradient the
    library's backward-filter."""
    x, w3 = ctx.saved_tensors
    if x.dtype != torch.float32:
        raise NotImplementedError(
            "conv3x3_s2d has no backward for bfloat16 x: the JAX reference's "
            "VJP raises TypeError there (ops/pallas/conv.py:164-171 convolves "
            "the bfloat16 x with the float32 cotangent)")
    g = g.to(x.dtype).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = conv3x3_op(g, rotate(w3))
    if ctx.needs_input_grad[1]:
        dw = weight_grad(x, g)
        if w3.is_contiguous():  # else w3 is a view of an OIHW weight, as dw
            dw = dw.contiguous()
    return dx, dw


conv3x3_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.san.conv3x3)
def _flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """What `FlopCounterMode` counts for the op: 2 x N H W x 9 Cin x Cout,
    as it counts the same conv through aten's convolution."""
    n, h, w, cin = x_shape
    return 2 * n * h * w * 9 * cin * w_shape[3]


def conv3x3_s2d(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC, no bias: x [N, H, W, Cin], w3 [3, 3,
    Cin, Cout] -> [N, H, W, Cout] in x's dtype, accumulated in f32. H and W
    must be even. Differentiable in f32 (bf16 has no backward, as in the
    JAX reference).

    The JAX package's name and signature (less `interpret`): "s2d" names
    the TPU kernel's space-to-depth decomposition, a 2x2 GEMM over 2x2
    pixel groups that fills the MXU's lanes. The port computes the same
    function directly, as an implicit GEMM on the card."""
    if x.dtype not in DTYPES or w3.dtype not in DTYPES:
        raise TypeError(f"conv3x3_s2d takes float32 or bfloat16, got {x.dtype} "
                        f"and {w3.dtype}")
    check(x, w3)
    on_card(x)  # any other device raises here, before the op records
    return conv3x3_op(x, w3.to(x.dtype))
