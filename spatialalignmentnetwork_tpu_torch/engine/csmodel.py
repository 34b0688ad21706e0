"""CSModel, serving subset (counterpart of the JAX package's
`engine/csmodel.py`).

Serving reconstructs a slice from its own undersampled k-space, guided by
a reference modality aligned to it:

    _prepare     fft2 -> apply the fixed `pruned` mask -> ifft2
    net_T        SpatialTransformer(|aux|, |sampled|) -> f32 grid
    warp         bilinear grid sample of |aux| (the CUDA kernel on a card)
    net_R        VarNet(k_sampled, mask, warped, num_low) -> rss image

Only forward/serving at f32 is ported: training, net_G/net_D, the bf16
policy and the LOUPE build wait for later slices. Nets are built from the
cfg keys of the JAX `CSModel.build`, so a checkpoint the JAX package saved
loads here (`load`), with weights carried over by `engine/from_jax.py`.

The model lives on `device`, "cuda" unless the caller asks for "cpu"; with
no card and no explicit "cpu" it raises rather than run on the CPU.
"""

import numpy as np
import torch

from ..models.stn import SpatialTransformer, warp
from ..models.varnet import VarNet
from ..ops import masks as masks_lib
from ..ops.fft import fft2, ifft2, rss
from . import from_jax
from .checkpoint import ckpt_load

NET_NAMES = ("net_mask", "net_G", "net_D", "net_T", "net_R")


def resolve_device(device) -> torch.device:
    """The device to serve on: "cuda" needs a card (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def f32_precision():
    """Serve at true f32: cuDNN runs f32 convs in TF32 by default (10
    mantissa bits), which the JAX reference never does; pin both switches
    off. Process-wide, like the switches themselves."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class CSModel:
    """Serving facade owning net_T, net_R and the k-space mask."""

    def __init__(self, cfg=None, ckpt=None, device="cuda", seed=0):
        self.device = resolve_device(device)
        self.seed = seed
        f32_precision()
        if ckpt is not None:
            self.load(ckpt, cfg)
        else:
            self.build(cfg)

    # ------------------------------------------------------------------ build
    def build(self, cfg, pruned=None):
        """Nets from `cfg`; the mask from `pruned` when given (a checkpoint's),
        else generated from cfg.mask and the seed."""
        if cfg is None:
            raise ValueError("CSModel needs a cfg or a checkpoint")
        if cfg.get("use_amp", False):
            raise NotImplementedError("the bf16 policy (use_amp) is not ported yet")
        self.cfg = cfg
        t_layers = tuple(cfg.get("net_T_layers", (32, 64, 64, 64, 64)))
        gen = torch.Generator().manual_seed(self.seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(torch.randint(2**31, (1,), generator=gen)))
            self.net_T = SpatialTransformer(
                channels=cfg.coils, feat=t_layers[0], layers=t_layers
            )
            self.net_R = VarNet(
                num_cascades=cfg.get("net_R_cascades", 8),
                sens_chans=cfg.get("net_R_sens_chans", 8),
                sens_pools=cfg.get("net_R_sens_pools", 4),
                chans=cfg.get("net_R_chans", 18),
                pools=cfg.get("net_R_pools", 4),
                use_ref=True,
            )
        # zero-init head => identity transform at init, as in training
        torch.nn.init.zeros_(self.net_T.head.weight)
        torch.nn.init.zeros_(self.net_T.head.bias)
        self.net_T.to(self.device).eval()
        self.net_R.to(self.device).eval()
        if pruned is None:
            pruned = masks_lib.make_mask(
                cfg.mask, cfg.shape, cfg.get("sparsity"), seed=self.seed
            ).pruned
        self.pruned = torch.as_tensor(
            np.asarray(pruned).astype(bool), device=self.device
        )

    @property
    def num_low_frequencies(self) -> int:
        if self.cfg.get("sparsity") is None:
            raise ValueError(
                "cfg.sparsity is required to derive num_low_frequencies "
                "(ACS width = shape * sparsity * 0.32)"
            )
        # int() truncation, not center_len_for's round()
        return int(self.cfg.shape * self.cfg.sparsity * 0.32)

    # ------------------------------------------------------------ checkpoint
    def load(self, ckpt, cfg=None):
        """Load a checkpoint directory the JAX `CSModel.save` wrote."""
        loaded = ckpt_load(ckpt)
        saved_cfg = loaded.pop("config", None)
        self.build(cfg if cfg is not None else saved_cfg,
                   pruned=loaded.get("net_mask", {}).get("pruned"))
        self.load_entries(loaded)

    def load_entries(self, entries: dict):
        """Set weights from JAX checkpoint entries {'net_T': flat, ...}.
        net_G / net_D are not part of serving and are skipped."""
        for name in entries:
            if name not in NET_NAMES and name != "opt_state":
                raise KeyError(f"unknown checkpoint entry {name!r}")
        if "net_T" in entries:
            from_jax.load_stn(self.net_T, entries["net_T"])
        if "net_R" in entries:
            from_jax.load_varnet(self.net_R, entries["net_R"])
        mask_entry = entries.get("net_mask", {})
        if "pruned" in mask_entry:
            self.pruned = torch.as_tensor(
                np.asarray(mask_entry["pruned"]).astype(bool), device=self.device
            )

    # ---------------------------------------------------------------- forward
    def _prepare(self, img_full, img_aux, pruned):
        """Undersample `img_full` with the fixed `pruned` vector."""
        img_k_sampled = masks_lib.apply_mask(fft2(img_full), pruned)
        return {
            "img_aux": img_aux,
            "img_k_sampled": img_k_sampled,
            "img_sampled": ifft2(img_k_sampled),
        }

    def recon_step(self, img_full, img_aux):
        """The eval-mode serving computation on device tensors."""
        env = self._prepare(img_full, img_aux, self.pruned)
        aux_abs = env["img_aux"].abs()
        sampled_abs = env["img_sampled"].abs()
        _, grid = self.net_T(aux_abs, sampled_abs)
        img_warped = warp(aux_abs, grid)
        mask = torch.logical_not(self.pruned)[None, None, None, :]
        return self.net_R(
            env["img_k_sampled"], mask, img_warped, self.num_low_frequencies
        )

    def reconstruct(self, img_full, img_aux=None):
        """Serving path: undersample per the model's mask and reconstruct.

        img_full: complex [N, coils, H, W] fully-sampled image (numpy array
        or tensor); img_aux: the reference modality or None (zeros).
        Returns the reconstruction [N, 1, H, W] (real) on the model's device.
        """
        img_full = torch.as_tensor(img_full, device=self.device)
        img_aux = (
            torch.zeros_like(img_full) if img_aux is None
            else torch.as_tensor(img_aux, device=self.device)
        )
        with torch.inference_mode():
            return self.recon_step(
                img_full.to(torch.complex64), img_aux.to(torch.complex64)
            )
