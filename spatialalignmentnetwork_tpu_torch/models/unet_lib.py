"""Recursive U-Net with BatchNorm + LeakyReLU(0.01) (counterpart of the JAX
package's `models/unet_lib.py`: LibUNet, and the library factories
Encoder, Decoder and ResNet, which no path of the package calls).

Every level nests the next and returns cat([f(x), x]) on channels:
avg-pool + 1x1 conv down, residual conv stacks, nearest-upsample + 1x1
conv up. Submodules are registered in execution order, so the
`state_dict` lists the convs and BatchNorms in the order they run — the
order in which the JAX package numbers its `Conv_k` / `BatchNorm_k`.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum
from . import remat
from .layers import Conv2d, avg_pool2, stat_dtype, upsample_nearest2


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's `BatchNorm(momentum=0.9)` training semantics,
    the JAX package's (its models/unet_lib.py:34-37).

    Training normalises with the batch's biased variance, as both
    frameworks do, but updates the running statistics as flax does:
    running = 0.9 * running + 0.1 * batch, with the BIASED batch variance
    taken flax's way, mean(x^2) - mean(x)^2 (torch's own BatchNorm2d
    updates with the unbiased variance). Evaluation is torch's. The
    `state_dict` names are torch's.

    As flax's `BatchNorm(dtype=...)`: statistics and normalisation in at
    least f32, the output in `compute_dtype` where one is set, else in
    the input's dtype. The recomputation of a checkpointed forward
    (`models/remat.py`) normalises alike but leaves the running
    statistics alone: the forward updated them.

    With `mesh` set (a data-parallel step, `parallel/mesh.py`), training
    takes the statistics of the global batch, the rows of every rank, as
    XLA's partitioner does for the JAX package: the f32 per-channel sums
    of x and x^2 and the element count go through one differentiable
    all_reduce, and the normalisation's variance is two-pass, as
    `F.batch_norm`'s on one process: a second all_reduce of the sums of
    (x - mean)^2 (E[x^2] - E[x]^2 would cancel where the mean is large
    beside the spread). The running statistics take the global mean and
    flax's one-pass variance. Gradients flow back through both
    all_reduces into every rank's rows. A rank may hold no rows."""

    compute_dtype = None
    mesh = None

    def forward(self, x):
        out_dtype = self.compute_dtype or x.dtype
        x = x.to(stat_dtype(x.dtype))
        if not self.training:
            return super().forward(x).to(out_dtype)
        if self.mesh is not None:
            return self._global_forward(x).to(out_dtype)
        if not remat.recomputing():
            with torch.no_grad():
                mean = x.mean(dim=(0, 2, 3))
                var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(out_dtype)

    def _update_running(self, mean, var):
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var)

    def _global_forward(self, x):
        c = x.shape[1]
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
        sums = all_reduce_sum(self.mesh, torch.cat([x.sum(dims), (x * x).sum(dims), count]))
        n = sums[2 * c]
        mean = sums[:c] / n
        centered = x - mean[None, :, None, None]
        var = all_reduce_sum(self.mesh, (centered * centered).sum(dims)) / n
        if not remat.recomputing():
            with torch.no_grad():
                self._update_running(
                    mean, torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0))
        scale = self.weight * torch.rsqrt(var + self.eps)
        return centered * scale[None, :, None, None] + self.bias[None, :, None, None]


class ConvBNAct(nn.Module):
    """conv (with bias) -> BatchNorm (eps 1e-5) -> LeakyReLU(0.01)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
        self.bn = BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.01)


class Res(nn.Module):
    """x + (ConvBNAct)^n(x)."""

    def __init__(self, ch: int, n_convs: int):
        super().__init__()
        self.body = nn.Sequential(*(ConvBNAct(ch, ch) for _ in range(n_convs)))

    def forward(self, x):
        return x + self.body(x)


class Level(nn.Module):
    """Nested level `depth` (1-based) of `layers`: cat([f(x), x])."""

    def __init__(self, layers: Sequence[int], depth: int):
        super().__init__()
        cur, upper = layers[depth], layers[depth - 1]
        self.down = ConvBNAct(upper, cur, kernel=1)
        self.down_res = Res(cur, 2)
        self.inner = None
        if depth < len(layers) - 1:
            self.inner = Level(layers, depth + 1)
            self.merge = ConvBNAct(layers[depth + 1] + cur, cur)
            self.merge_res = Res(cur, 1)
        self.up = ConvBNAct(cur, cur, kernel=1)

    def forward(self, x):
        y = self.down_res(self.down(avg_pool2(x)))
        if self.inner is not None:
            y = self.merge_res(self.merge(self.inner(y)))
        y = self.up(upsample_nearest2(y))
        return torch.cat([y, x], dim=1)


class LibUNet(nn.Module):
    """LibUNet(in, out, layers), layers: channel widths per level, e.g.
    (32, 64, 64, 64, 64). Ends in a plain conv3x3 (no BN/activation)."""

    def __init__(self, in_chans: int, out_chans: int, layers: Sequence[int]):
        super().__init__()
        layers = list(layers)
        l0 = layers[0]
        self.head = ConvBNAct(in_chans, l0)
        self.head_res = Res(l0, 1)
        self.inner = Level(layers, 1)
        self.tail = ConvBNAct(layers[1] + l0, l0)
        self.tail_res = Res(l0, 1)
        self.out = Conv2d(l0, out_chans, 3, padding=1)

    def forward(self, x):
        x = self.head_res(self.head(x))
        x = self.inner(x)
        x = self.tail_res(self.tail(x))
        return self.out(x)


def _cna(in_ch: int, out_ch: int) -> nn.Module:
    """conv3x3 (with bias) -> LeakyReLU(0.01), norm-free."""
    return nn.Sequential(Conv2d(in_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.01))


class _CnaRes(nn.Module):
    """x + (conv3x3 -> LeakyReLU)^2(x)."""

    def __init__(self, ch: int):
        super().__init__()
        self.body = nn.Sequential(_cna(ch, ch), _cna(ch, ch))

    def forward(self, x):
        return x + self.body(x)


class Encoder(nn.Module):
    """Feature-pyramid encoder: a conv + LeakyReLU stem and a residual
    block a level, avg-pool between levels, a last conv at the deepest
    level; returns the features of every level, shallowest first."""

    def __init__(self, in_chans: int, layers: Sequence[int]):
        super().__init__()
        chs = list(layers)
        if len(chs) < 2:
            raise ValueError(f"an Encoder needs at least 2 levels, got {chs}")
        self.levels = nn.ModuleList()
        prev = in_chans
        for i, ch in enumerate(chs):
            last = i == len(chs) - 1
            self.levels.append(_cna(prev, ch) if last
                               else nn.Sequential(_cna(prev, ch), _CnaRes(ch)))
            prev = ch

    def forward(self, x):
        feats = []
        for i, level in enumerate(self.levels):
            if i > 0:
                x = avg_pool2(x)
            x = level(x)
            feats.append(x)
        return feats


class Decoder(nn.Module):
    """Bridged decoder over an encoder's features (shallowest first, of
    `bridges` channels): from the deepest level up, cat the bridge, conv +
    LeakyReLU, a residual block, then a nearest upsample, or at level 0 a
    plain conv3x3 to `out_chans`."""

    def __init__(self, out_chans: int, layers: Sequence[int], bridges: Sequence[int]):
        super().__init__()
        layers, bridges = list(layers), list(bridges)
        if len(layers) != len(bridges):
            raise ValueError(f"{len(layers)} layers for {len(bridges)} bridges")
        self.levels = nn.ModuleList()
        prev = 0
        for level in reversed(range(len(layers))):
            ch = layers[level]
            self.levels.append(nn.Sequential(_cna(prev + bridges[level], ch), _CnaRes(ch)))
            prev = ch
        self.out = Conv2d(layers[0], out_chans, 3, padding=1)

    def forward(self, bridges):
        x = None
        for i, (level, bridge) in enumerate(zip(self.levels, reversed(bridges))):
            x = bridge if x is None else torch.cat([x, bridge], dim=1)
            x = level(x)
            if i < len(self.levels) - 1:
                x = upsample_nearest2(x)
        return self.out(x)


class ResBlock(nn.Module):
    """LeakyReLU, then conv3x3 -> LeakyReLU -> conv3x3 beside a shortcut
    (a 1x1 conv where the channels change) of the activated input."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_a = Conv2d(in_ch, out_ch, 3, padding=1)
        self.conv_b = Conv2d(out_ch, out_ch, 3, padding=1)
        self.shortcut = None if in_ch == out_ch else Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        y = F.leaky_relu(x, 0.01)
        z = self.conv_b(F.leaky_relu(self.conv_a(y), 0.01))
        return (y if self.shortcut is None else self.shortcut(y)) + z


class ResNet(nn.Module):
    """Plain conv ResNet: conv3x3(in -> c0), a chain of ResBlocks, with
    `res` a long shortcut around the chain (a 1x1 conv where c0 != c_last),
    LeakyReLU, conv3x3(c_last -> out)."""

    def __init__(self, in_chans: int, out_chans: int,
                 channels: Sequence[int] = (64, 64, 64, 64), res: bool = False):
        super().__init__()
        chs = list(channels)
        self.stem = Conv2d(in_chans, chs[0], 3, padding=1)
        self.blocks = nn.Sequential(*(ResBlock(a, b) for a, b in zip(chs[:-1], chs[1:])))
        self.res = res
        self.long_shortcut = (Conv2d(chs[0], chs[-1], 1)
                              if res and chs[0] != chs[-1] else None)
        self.out = Conv2d(chs[-1], out_chans, 3, padding=1)

    def forward(self, x):
        x = self.stem(x)
        y = self.blocks(x)
        if self.res:
            y = y + (x if self.long_shortcut is None else self.long_shortcut(x))
        return self.out(F.leaky_relu(y, 0.01))
