"""Cross-modality synthesis GAN: a spectral-norm U-Net generator and a
patch discriminator with a hinge loss (counterpart of the JAX package's
`models/gan.py`).

  * SpectralConv: a conv under spectral normalisation with the reference's
    `torch.nn.utils.spectral_norm` names (`weight_orig`, `bias`, buffers
    `weight_u` [out] and `weight_v` [in*kh*kw]), normalising as the JAX
    package does: x / (|x| + eps). A train-mode forward runs one power
    iteration, stores u and v, then divides the weight by
    sigma = u . (W v); an eval-mode forward uses the stored vectors.
    Gradients flow through sigma into the weight, never into u and v.
    With a compute dtype (bf16), sigma stays f32 and the normalised
    weight, the input and the bias are cast to it.
  * SNConv: [BatchNorm ->] ReLU -> SpectralConv, xavier-normal init.
  * NetG: a recursively nested concat-skip U-Net, 2x2 stride-2 conv down,
    nearest-upsample up, BatchNorm.
  * NetD: a norm-free conv stack with avg-pool downsampling, ending in a
    1-channel patch map.
  * loss_gan: D: mean(clamp(-/+pred, min=-1)); G: mean(-pred).

NCHW throughout. Submodules are registered in the order they run, so the
SNConv modules of a `state_dict` come in the JAX package's `SNConv_k`
order (`engine/from_jax.py::snconv_entries` zips them).
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import remat
from .layers import avg_pool2, upsample_nearest2
from .unet_lib import BatchNorm2d


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class SpectralConv(nn.Module):
    """Conv2d (with bias) under spectral normalisation; `kernel` x `kernel`
    taps, stride `stride`, padding kernel // 2 at stride 1 and none
    otherwise (the 2x2 stride-2 down conv)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, eps: float = 1e-12, generator=None):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2 if stride == 1 else 0
        self.eps = eps
        self.weight_orig = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("weight_u", torch.empty(out_ch))
        self.register_buffer("weight_v", torch.empty(in_ch * kernel * kernel))
        nn.init.xavier_normal_(self.weight_orig, generator=generator)
        with torch.no_grad():
            for buf in (self.weight_u, self.weight_v):
                buf.copy_(_l2_normalize(
                    torch.randn(buf.shape, generator=generator), eps))

    compute_dtype = None

    def forward(self, x):
        w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        if self.training and remat.recomputing():
            u, v = remat.replay()  # the forward's vectors, stored once
        elif self.training:
            with torch.no_grad():
                v = _l2_normalize(w_mat.t() @ self.weight_u, self.eps)
                u = _l2_normalize(w_mat @ v, self.eps)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            remat.record((u, v))
        else:
            # clones: autograd saves u and v, and a later train-mode
            # forward writes the buffers in place
            u, v = self.weight_u.clone(), self.weight_v.clone()
        # the power iteration and sigma in the parameters' f32, then the
        # normalised weight, the input and the bias in the compute dtype
        sigma = torch.dot(u, w_mat @ v)
        w, bias = self.weight_orig / sigma, self.bias
        if self.compute_dtype is not None:
            x, w, bias = (t.to(self.compute_dtype) for t in (x, w, bias))
        return F.conv2d(x, w, bias, self.stride, self.padding)


class SNConv(nn.Module):
    """[BatchNorm (flax momentum 0.9, eps 1e-5) ->] ReLU -> SpectralConv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, use_norm: bool = True, generator=None):
        super().__init__()
        self.bn = BatchNorm2d(in_ch, eps=1e-5) if use_norm else None
        self.conv = SpectralConv(in_ch, out_ch, kernel, stride,
                                 generator=generator)

    def forward(self, x):
        if self.bn is not None:
            x = self.bn(x)
        return self.conv(F.relu(x))


class SNRes(nn.Module):
    """x + SNConv^n(x)."""

    def __init__(self, ch: int, n: int, generator=None):
        super().__init__()
        self.body = nn.Sequential(*(SNConv(ch, ch, generator=generator)
                                    for _ in range(n)))

    def forward(self, x):
        return x + self.body(x)


class GLevel(nn.Module):
    """Nested level `depth` (1-based) of NetG: cat([f(x), x]) on channels,
    f = down conv, 2 residual convs, [the next level, a conv, 1 residual
    conv,] nearest upsample."""

    def __init__(self, layers: Sequence[int], depth: int, generator=None):
        super().__init__()
        cur, upper = layers[depth], layers[depth - 1]
        self.down = SNConv(upper, cur, kernel=2, stride=2, generator=generator)
        self.down_res = SNRes(cur, 2, generator)
        self.inner = None
        if depth < len(layers) - 1:
            self.inner = GLevel(layers, depth + 1, generator)
            self.merge = SNConv(layers[depth + 1] + cur, cur, generator=generator)
            self.merge_res = SNRes(cur, 1, generator)

    def forward(self, x):
        y = self.down_res(self.down(x))
        if self.inner is not None:
            y = self.merge_res(self.merge(self.inner(y)))
        return torch.cat([upsample_nearest2(y), x], dim=1)


class NetG(nn.Module):
    """Spectral-norm synthesis U-Net; layers e.g. (64, 128, 256, 512, 512),
    in and out 1 channel."""

    def __init__(self, in_chans: int = 1, out_chans: int = 1,
                 layers: Sequence[int] = (64, 128, 256, 512, 512), generator=None):
        super().__init__()
        layers = list(layers)
        l0 = layers[0]
        self.head = SNConv(in_chans, l0, generator=generator)
        self.head_res = SNRes(l0, 1, generator)
        self.inner = GLevel(layers, 1, generator)
        self.tail = SNConv(layers[1] + l0, l0, generator=generator)
        self.tail_res = SNRes(l0, 1, generator)
        self.out = SNConv(l0, out_chans, generator=generator)

    def forward(self, x):
        x = self.head_res(self.head(x))
        x = self.inner(x)
        x = self.tail_res(self.tail(x))
        return self.out(x)


class NetD(nn.Module):
    """Norm-free spectral-norm patch discriminator; blocks e.g.
    ((64,)*2, (128,)*2, (256,)*2, (256,)*2, (256,)*2), 2 input channels.
    Each block is a conv stack followed by a 2x2 avg-pool, the last
    block's pool replaced by a 1-channel conv (`head`)."""

    def __init__(self, blocks: Sequence[Sequence[int]] = ((64,) * 2, (128,) * 2, (256,) * 2,
                                                         (256,) * 2, (256,) * 2),
                 in_chans: int = 2, generator=None):
        super().__init__()
        convs = []
        ch = in_chans
        for block in blocks:
            stack = []
            for out in block:
                stack.append(SNConv(ch, out, use_norm=False, generator=generator))
                ch = out
            convs.append(nn.Sequential(*stack))
        self.blocks = nn.ModuleList(convs)
        self.head = SNConv(ch, 1, use_norm=False, generator=generator)

    def forward(self, x):
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.blocks) - 1:
                x = avg_pool2(x)
        return self.head(x)


def loss_gan(predict: torch.Tensor, real: bool = True, D_loss: bool = True) -> torch.Tensor:
    """Hinge-style GAN loss: for D, mean(clamp(-pred if real else pred,
    min=-1)); for G, mean(-pred) (a fake scored as real)."""
    if real and not D_loss:
        raise ValueError("are you sure? loss_gan(real=True, D_loss=False)")
    if D_loss:
        loss = torch.clamp(-predict if real else predict, min=-1.0)
    else:
        loss = -predict
    return torch.mean(loss)
