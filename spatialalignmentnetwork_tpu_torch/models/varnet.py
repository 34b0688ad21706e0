"""End-to-end variational network (counterpart of the JAX package's
`models/varnet.py`, plain layout).

The cascades are a Python loop over `num_cascades` VarNetBlocks, each
with its own parameters (`cascades.{c}.model.unet.*`,
`cascades.{c}.dc_weight`), where the JAX package scans one block over
parameters stacked on a leading axis. The `use_ref` channel injects the
warped reference image into every cascade's U-Net; its preprocessing
(rss -> instance norm -> pad to 16) runs once, before the loop. With
`remat` a training forward keeps only each cascade's input k-space and
the backward recomputes the cascade (the JAX package's `nn.remat` around
its scan body, `cfg.net_R_remat`). The k-space chain stays complex64
under the bf16 policy; each NormUnet computes its U-Net in bf16.
"""

import torch
from torch import nn

from ..ops.fft import fft2, ifft2, rss
from . import remat as remat_lib
from .layers import instance_norm
from .unet import NormUnet, pad_to_16


def acs_mask(width: int, num_low_frequencies: int, device="cpu") -> torch.Tensor:
    """[W] float mask keeping only the ACS low-frequency lines in corner-DC
    layout: the first `num_low` columns rolled by (-num_low)//2 (Python
    floor division of the NEGATED count, as in the reference)."""
    m = (torch.arange(width, device=device) < num_low_frequencies).to(torch.float32)
    return torch.roll(m, (-num_low_frequencies) // 2)


class SensitivityModel(nn.Module):
    """Coil sensitivity maps from the ACS region of masked k-space."""

    def __init__(self, chans: int, num_pools: int):
        super().__init__()
        self.norm_unet = NormUnet(chans, num_pools)

    def forward(self, masked_kspace: torch.Tensor, num_low_frequencies: int):
        n, c, h, w = masked_kspace.shape
        m = acs_mask(w, num_low_frequencies, masked_kspace.device)
        acs_images = ifft2(masked_kspace * m[None, None, None, :])
        # each coil is estimated on its own: fold coils into the batch
        sens = self.norm_unet(acs_images.reshape(n * c, 1, h, w))
        sens = sens.reshape(n, c, h, w)
        return sens / (rss(sens) + 1e-6)


class VarNetBlock(nn.Module):
    """One unrolled cascade: k <- k - soft_dc - F S refine(S* F^-1 k)."""

    def __init__(self, model: NormUnet):
        super().__init__()
        self.model = model
        self.dc_weight = nn.Parameter(torch.ones(1))

    def forward(self, current_kspace, ref_kspace, mask, sens_maps, ref_image):
        image = torch.sum(
            ifft2(current_kspace) * torch.conj(sens_maps), dim=1, keepdim=True
        )
        image = self.model(image, ref_image)
        model_term = fft2(image * sens_maps)
        soft_dc = torch.where(
            mask, current_kspace - ref_kspace, 0.0
        ) * self.dc_weight
        return current_kspace - soft_dc - model_term


class VarNet(nn.Module):
    """forward(masked_kspace [N,C,H,W] complex, mask (broadcastable bool),
    ref [N,C,H,W] real or None, num_low_frequencies) -> [N,1,H,W] real."""

    def __init__(self, num_cascades: int = 12, sens_chans: int = 8,
                 sens_pools: int = 4, chans: int = 18, pools: int = 4,
                 use_ref: bool = False, remat: bool = False):
        super().__init__()
        self.use_ref = use_ref
        self.remat = remat
        self.sens_net = SensitivityModel(sens_chans, sens_pools)
        self.cascades = nn.ModuleList(
            VarNetBlock(NormUnet(chans, pools, use_ref=use_ref,
                                 ref_prenormalized=True))
            for _ in range(num_cascades)
        )

    def forward(self, masked_kspace, mask, ref, num_low_frequencies: int):
        sens_maps = self.sens_net(masked_kspace, num_low_frequencies)
        if self.use_ref:
            # raw RSS magnitude: two-pass statistics (a near-flat plane
            # cancels all variance bits in the one-pass form)
            ref, _ = pad_to_16(instance_norm(rss(ref)))
        else:
            ref = None
        if mask.ndim == 1:
            mask = mask[None, None, None, :]
        kspace_pred = masked_kspace
        remat = self.remat and torch.is_grad_enabled()
        for cascade in self.cascades:
            args = (kspace_pred, masked_kspace, mask, sens_maps, ref)
            kspace_pred = remat_lib.checkpoint(cascade, *args) if remat else cascade(*args)
        return rss(ifft2(kspace_pred))
