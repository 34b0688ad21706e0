"""Roundings that put the reference in another precision: the control of
`correct`, one step below the precision a configuration states, and the
yardstick of a bf16 cell, the reference's own bf16. Each rounds every
conv's operands, and bf16 its output too (`nets.set_quant`), the
products summed in f32 as the tensor cores do.

  tf32  round to nearest at 10 mantissa bits: what cuDNN's TF32 path
        does to an f32 conv's operands (the step below f32 with TF32 off)
  fp8   float8 e4m3 with a per-tensor scale to its largest value, 448:
        the step below bf16
  bf16  round to nearest at 7 mantissa bits, operands and output: the
        bf16 policy's convs (their inputs, weights and outputs in bf16)
"""

import torch

FP8_MAX = 448.0


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 `x` rounded to nearest (ties to even) at `bits` mantissa bits."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    return round_mantissa(x.to(torch.float32), 10)


def fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    amax = x.abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def straight_through(fn):
    """fn's rounding in the forward, the identity in the backward, so that
    the control trains: the backward's convs read the rounded operands."""
    def rounded(x):
        return x + (fn(x) - x).detach()
    return rounded


def bf16(x: torch.Tensor) -> torch.Tensor:
    return round_mantissa(x.to(torch.float32), 7)


# name: (the operands' rounding, the output's)
ROUNDINGS = {"tf32": (straight_through(tf32), None), "fp8": (straight_through(fp8), None),
             "bf16": (straight_through(bf16), straight_through(bf16))}
