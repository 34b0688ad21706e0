"""Recursive U-Net with BatchNorm + LeakyReLU(0.01) (counterpart of the JAX
package's `models/unet_lib.py::LibUNet`; Encoder, Decoder and ResNet are
not ported yet).

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

from .layers import avg_pool2, upsample_nearest2


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's `BatchNorm(momentum=0.9)` training semantics,
    the JAX package's (its models/unet_lib.py:34-37).

    Training normalises with the batch's biased variance, as both
    frameworks do, but updates the running statistics as flax does:
    running = 0.9 * running + 0.1 * batch, with the BIASED batch variance
    taken flax's way, mean(x^2) - mean(x)^2 (torch's own BatchNorm2d
    updates with the unbiased variance). Evaluation is torch's. The
    `state_dict` names are torch's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class ConvBNAct(nn.Module):
    """conv (with bias) -> BatchNorm (eps 1e-5) -> LeakyReLU(0.01)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
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
        self.out = nn.Conv2d(l0, out_chans, 3, padding=1)

    def forward(self, x):
        x = self.head_res(self.head(x))
        x = self.inner(x)
        x = self.tail_res(self.tail(x))
        return self.out(x)
