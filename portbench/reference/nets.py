"""The plain reference's networks: net_T (STN), net_R (VarNet), net_G and
net_D, in plain PyTorch.

A frozen copy of the model math of `spatialalignmentnetwork_tpu_torch/
models/` (layers.py, unet.py, varnet.py, unet_lib.py, stn.py, gan.py) at
commit 3f2e19a, with the state-dict names kept so that one set of weights
loads into both. It imports nothing of the port. What it leaves out: the
bf16 policy (the reference computes in f32), remat and the data-parallel
BatchNorm. What it adds: `quant` and `quant_out`, roundings applied to
every conv's operands and to its output, which put the reference in
another precision (`precision.py`), and checkpointed cascades (`VarNet(checkpoint=True)`),
which change no value and let the f32 reference of a large batch fit.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .ops import fft2, identity_grid, ifft2, rss


def _q(module, *tensors):
    quant = getattr(module, "quant", None)
    if quant is None:
        return tensors
    return tuple(None if t is None else quant(t) for t in tensors)


def _q_out(module, y):
    return y if module.quant_out is None else module.quant_out(y)


class Conv2d(nn.Conv2d):
    quant = quant_out = None

    def forward(self, x):
        x, w, b = _q(self, x, self.weight, self.bias)
        return _q_out(self, self._conv_forward(x, w, b))


class ConvTranspose2d(nn.ConvTranspose2d):
    quant = quant_out = None

    def forward(self, x):
        x, w, b = _q(self, x, self.weight, self.bias)
        return _q_out(self, F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                               self.output_padding, self.groups, self.dilation))


def set_quant(module: nn.Module, quant, quant_out=None) -> nn.Module:
    """Give every conv of `module` the roundings of its operands and of
    its output (None: none)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, SpectralConv)):
            m.quant, m.quant_out = quant, quant_out
    return module


def instance_norm(x, eps=1e-5):
    var, mean = torch.var_mean(x, dim=(-2, -1), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layers = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False), InstanceNorm(), nn.LeakyReLU(0.2),
            Conv2d(cout, cout, 3, padding=1, bias=False), InstanceNorm(), nn.LeakyReLU(0.2))

    def forward(self, x):
        return self.layers(x)


class TransposeConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layers = nn.Sequential(
            ConvTranspose2d(cin, cout, 2, stride=2, bias=False), InstanceNorm(),
            nn.LeakyReLU(0.2))

    def forward(self, x):
        return self.layers(x)


def avg_pool2(x):
    return F.avg_pool2d(x, 2, stride=2)


def upsample_nearest2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Unet(nn.Module):
    def __init__(self, cin, cout, chans, pools):
        super().__init__()
        self.down_sample_layers = nn.ModuleList([ConvBlock(cin, chans)])
        ch = chans
        for _ in range(pools - 1):
            self.down_sample_layers.append(ConvBlock(ch, ch * 2))
            ch *= 2
        self.conv = ConvBlock(ch, ch * 2)
        self.up_conv = nn.ModuleList()
        self.up_transpose_conv = nn.ModuleList()
        for _ in range(pools - 1):
            self.up_transpose_conv.append(TransposeConvBlock(ch * 2, ch))
            self.up_conv.append(ConvBlock(ch * 2, ch))
            ch //= 2
        self.up_transpose_conv.append(TransposeConvBlock(ch * 2, ch))
        self.up_conv.append(nn.Sequential(ConvBlock(ch * 2, ch), Conv2d(ch, cout, 1)))

    def forward(self, x):
        stack = []
        for layer in self.down_sample_layers:
            x = layer(x)
            stack.append(x)
            x = avg_pool2(x)
        x = self.conv(x)
        for tconv, conv in zip(self.up_transpose_conv, self.up_conv):
            skip = stack.pop()
            x = tconv(x)
            pad_w, pad_h = skip.shape[-1] - x.shape[-1], skip.shape[-2] - x.shape[-2]
            if pad_w or pad_h:
                x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
            x = conv(torch.cat([x, skip], dim=1))
        return x


def group_norm_2(x, eps=1e-6):
    """Two groups (real, imaginary channels) by mean and unbiased std."""
    b, c, h, w = x.shape
    var, mean = torch.var_mean(x.reshape(b, 2, -1), dim=2, correction=1)
    nz = var > 0
    std = torch.where(nz, torch.sqrt(torch.where(nz, var, 1.0)), 0.0)
    mean, std = mean.reshape(b, 2, 1, 1, 1), std.reshape(b, 2, 1, 1, 1)
    xn = (x.reshape(b, 2, c // 2, h, w) - mean) / (std + eps)
    return xn.reshape(b, c, h, w), mean, std


def pad_to_16(x):
    _, _, h, w = x.shape
    wm, hm = ((w - 1) | 15) + 1, ((h - 1) | 15) + 1
    wp = ((wm - w) // 2, (wm - w) - (wm - w) // 2)
    hp = ((hm - h) // 2, (hm - h) - (hm - h) // 2)
    return F.pad(x, (*wp, *hp)), (hp, wp, hm, wm)


def unpad_16(x, hp, wp, hm, wm):
    return x[..., hp[0]: hm - hp[1], wp[0]: wm - wp[1]]


class NormUnet(nn.Module):
    def __init__(self, chans, pools, use_ref=False):
        super().__init__()
        self.use_ref = use_ref
        self.unet = Unet(2 + (1 if use_ref else 0), 2, chans, pools)

    def forward(self, x, ref=None):
        x = torch.cat([x.real, x.imag], dim=1)
        x, mean, std = group_norm_2(x)
        x, pads = pad_to_16(x)
        if self.use_ref:  # ref arrives instance-normalised and padded
            x = torch.cat([x, ref], dim=1)
        x = unpad_16(self.unet(x), *pads)
        b, c, h, w = x.shape
        x = (x.reshape(b, 2, c // 2, h, w) * std + mean).reshape(b, c, h, w)
        return torch.complex(x[:, : c // 2], x[:, c // 2:])


def acs_mask(width, num_low, device):
    m = (torch.arange(width, device=device) < num_low).to(torch.float32)
    return torch.roll(m, (-num_low) // 2)


class SensitivityModel(nn.Module):
    def __init__(self, chans, pools):
        super().__init__()
        self.norm_unet = NormUnet(chans, pools)

    def forward(self, kspace, num_low):
        n, c, h, w = kspace.shape
        m = acs_mask(w, num_low, kspace.device)
        sens = self.norm_unet(ifft2(kspace * m[None, None, None, :]).reshape(n * c, 1, h, w))
        sens = sens.reshape(n, c, h, w)
        return sens / (rss(sens) + 1e-6)


class VarNetBlock(nn.Module):
    def __init__(self, chans, pools):
        super().__init__()
        self.model = NormUnet(chans, pools, use_ref=True)
        self.dc_weight = nn.Parameter(torch.ones(1))

    def forward(self, k, k0, mask, sens, ref):
        image = torch.sum(ifft2(k) * torch.conj(sens), dim=1, keepdim=True)
        model_term = fft2(self.model(image, ref) * sens)
        soft_dc = torch.where(mask, k - k0, 0.0) * self.dc_weight
        return k - soft_dc - model_term


class VarNet(nn.Module):
    def __init__(self, cascades, sens_chans, sens_pools, chans, pools, checkpoint=False):
        super().__init__()
        self.checkpoint = checkpoint
        self.sens_net = SensitivityModel(sens_chans, sens_pools)
        self.cascades = nn.ModuleList(VarNetBlock(chans, pools) for _ in range(cascades))

    def forward(self, k0, mask, ref, num_low):
        sens = self.sens_net(k0, num_low)
        ref, _ = pad_to_16(instance_norm(rss(ref)))
        k = k0
        for cascade in self.cascades:
            if self.checkpoint and torch.is_grad_enabled():
                k = checkpoint(cascade, k, k0, mask, sens, ref, use_reentrant=False)
            else:
                k = cascade(k, k0, mask, sens, ref)
        return rss(ifft2(k))


class BatchNorm2d(nn.BatchNorm2d):
    """flax's BatchNorm(momentum=0.9): batch statistics in training, the
    running ones updated with the biased one-pass variance."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, kernel=3):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.bn = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.01)


class Res(nn.Module):
    def __init__(self, ch, n):
        super().__init__()
        self.body = nn.Sequential(*(ConvBNAct(ch, ch) for _ in range(n)))

    def forward(self, x):
        return x + self.body(x)


class Level(nn.Module):
    def __init__(self, layers, depth):
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
        return torch.cat([self.up(upsample_nearest2(y)), x], dim=1)


class LibUNet(nn.Module):
    def __init__(self, cin, cout, layers):
        super().__init__()
        layers = list(layers)
        self.head = ConvBNAct(cin, layers[0])
        self.head_res = Res(layers[0], 1)
        self.inner = Level(layers, 1)
        self.tail = ConvBNAct(layers[1] + layers[0], layers[0])
        self.tail_res = Res(layers[0], 1)
        self.out = Conv2d(layers[0], cout, 3, padding=1)

    def forward(self, x):
        x = self.inner(self.head_res(self.head(x)))
        return self.out(self.tail_res(self.tail(x)))


class SpatialTransformer(nn.Module):
    """(moving, fixed) -> (offset, grid), both [N, H, W, 2]."""

    def __init__(self, layers):
        super().__init__()
        self.unet = LibUNet(2, layers[0], layers)
        self.head = Conv2d(layers[0], 2, 3, padding=1)

    def forward(self, moving, fixed):
        x = self.unet(torch.cat([moving, fixed], dim=1))
        offset = self.head(F.leaky_relu(x, 0.01)).permute(0, 2, 3, 1)
        return offset, identity_grid(moving.shape, moving.device) + offset


def _l2n(x, eps):
    return x / (torch.linalg.vector_norm(x) + eps)


class SpectralConv(nn.Module):
    """Conv under spectral normalisation: one power iteration a training
    forward (u, v stored, no gradient), then weight / (u . W v)."""

    quant = quant_out = None

    def __init__(self, cin, cout, kernel=3, stride=1, eps=1e-12):
        super().__init__()
        self.stride, self.eps = stride, eps
        self.padding = kernel // 2 if stride == 1 else 0
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("weight_u", torch.empty(cout))
        self.register_buffer("weight_v", torch.empty(cin * kernel * kernel))

    def forward(self, x):
        w_mat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        if self.training:
            with torch.no_grad():
                v = _l2n(w_mat.t() @ self.weight_u, self.eps)
                u = _l2n(w_mat @ v, self.eps)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:
            u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = torch.dot(u, w_mat @ v)
        x, w, b = _q(self, x, self.weight_orig / sigma, self.bias)
        return _q_out(self, F.conv2d(x, w, b, self.stride, self.padding))


class SNConv(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, use_norm=True):
        super().__init__()
        self.bn = BatchNorm2d(cin, eps=1e-5) if use_norm else None
        self.conv = SpectralConv(cin, cout, kernel, stride)

    def forward(self, x):
        if self.bn is not None:
            x = self.bn(x)
        return self.conv(F.relu(x))


class SNRes(nn.Module):
    def __init__(self, ch, n):
        super().__init__()
        self.body = nn.Sequential(*(SNConv(ch, ch) for _ in range(n)))

    def forward(self, x):
        return x + self.body(x)


class GLevel(nn.Module):
    def __init__(self, layers, depth):
        super().__init__()
        cur, upper = layers[depth], layers[depth - 1]
        self.down = SNConv(upper, cur, kernel=2, stride=2)
        self.down_res = SNRes(cur, 2)
        self.inner = None
        if depth < len(layers) - 1:
            self.inner = GLevel(layers, depth + 1)
            self.merge = SNConv(layers[depth + 1] + cur, cur)
            self.merge_res = SNRes(cur, 1)

    def forward(self, x):
        y = self.down_res(self.down(x))
        if self.inner is not None:
            y = self.merge_res(self.merge(self.inner(y)))
        return torch.cat([upsample_nearest2(y), x], dim=1)


class NetG(nn.Module):
    def __init__(self, layers: Sequence[int]):
        super().__init__()
        layers = list(layers)
        self.head = SNConv(1, layers[0])
        self.head_res = SNRes(layers[0], 1)
        self.inner = GLevel(layers, 1)
        self.tail = SNConv(layers[1] + layers[0], layers[0])
        self.tail_res = SNRes(layers[0], 1)
        self.out = SNConv(layers[0], 1)

    def forward(self, x):
        x = self.inner(self.head_res(self.head(x)))
        return self.out(self.tail_res(self.tail(x)))


class NetD(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        convs, ch = [], 2
        for block in blocks:
            stack = []
            for out in block:
                stack.append(SNConv(ch, out, use_norm=False))
                ch = out
            convs.append(nn.Sequential(*stack))
        self.blocks = nn.ModuleList(convs)
        self.head = SNConv(ch, 1, use_norm=False)

    def forward(self, x):
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.blocks) - 1:
                x = avg_pool2(x)
        return self.head(x)


def loss_gan(pred, real, d_loss):
    if d_loss:
        return torch.mean(torch.clamp(-pred if real else pred, min=-1.0))
    return torch.mean(-pred)


def build(model_cfg: dict, checkpoint_cascades=False) -> dict:
    """The four nets of a configuration's `model` block, on the current
    default device, their parameters uninitialised (the benchmark loads
    its weights into them)."""
    c = model_cfg
    return {
        "net_T": SpatialTransformer(tuple(c["net_T_layers"])),
        "net_R": VarNet(c["net_R_cascades"], c["net_R_sens_chans"], c["net_R_sens_pools"],
                        c["net_R_chans"], c["net_R_pools"], checkpoint=checkpoint_cascades),
        "net_G": NetG(tuple(c["net_G_layers"])),
        "net_D": NetD(tuple(tuple(b) for b in c["net_D_blocks"])),
    }
