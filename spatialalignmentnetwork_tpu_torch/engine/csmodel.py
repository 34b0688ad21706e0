"""CSModel: serving and the Rec / None train steps (counterpart of the JAX
package's `engine/csmodel.py`).

Serving reconstructs a slice from its own undersampled k-space, guided by
a reference modality aligned to it:

    _prepare     fft2 -> apply the fixed `pruned` mask -> ifft2
    net_T        SpatialTransformer(|aux|, |sampled|) -> f32 grid
    warp         bilinear grid sample of |aux| (the CUDA kernel on a card)
    net_R        VarNet(k_sampled, mask, warped, num_low) -> rss image

Training (`set_input` -> `update` -> `get_vis("scalars")`) runs the
regimes "Rec" (net_T and net_R learn from loss_sim * weight_sim +
loss_smooth * weight_smooth) and "None" (net_R alone learns from loss_sim;
the grid is detached), with loss_sim the SSIM loss of the reconstruction
against the fully sampled rss image (the CUDA SSIM kernels on a card) and
loss_smooth the displacement field's smoothness. Each net has its own Adam,
the counterpart of the JAX package's `optax.adamw(lr, weight_decay=0)`.
net_G / net_D (regimes Mixed, GAN-Only), gradient accumulation, the bf16
policy, LOUPE mask learning and per-cascade rematerialization wait for
later slices; `update` refuses a cfg that asks for one of them.

Nets are built from the cfg keys of the JAX `CSModel.build`, and
checkpoints go both ways in the JAX package's directory layout (`load`,
`save`), with weights and Adam moments carried by `engine/from_jax.py`.
What a loaded checkpoint holds for nets the port does not run yet (net_G
and net_D, their Adam state, net_mask's own entries) is kept as loaded and
written back by `save`.

The model lives on `device`, "cuda" unless the caller asks for "cpu"; with
no card and no explicit "cpu" it raises rather than run on the CPU.
"""

import numpy as np
import torch

from ..models.stn import SpatialTransformer, gradient_loss, warp
from ..models.varnet import VarNet
from ..ops import masks as masks_lib
from ..ops.fft import fft2, ifft2, rss
from ..ops.ssim import ssimloss
from . import from_jax
from .checkpoint import ckpt_load, ckpt_save

NET_NAMES = ("net_mask", "net_G", "net_D", "net_T", "net_R")

# which nets receive gradients per training regime (the JAX package's
# GRAD_NETS, engine/csmodel.py:121-126); the others wait for net_G / net_D
GRAD_NETS = {"None": ("net_R",), "Rec": ("net_T", "net_R")}
LATER_REGIMES = ("Mixed", "GAN-Only")


def resolve_device(device) -> torch.device:
    """The device to run on: "cuda" needs a card (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def f32_precision():
    """Run at true f32: cuDNN runs f32 convs in TF32 by default (10
    mantissa bits), which the JAX reference never does; pin both switches
    off. Process-wide, like the switches themselves."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class CSModel:
    """Facade owning net_T, net_R, their optimizers and the k-space mask."""

    def __init__(self, cfg=None, ckpt=None, device="cuda", seed=0):
        self.device = resolve_device(device)
        self.seed = seed
        self.training = True
        self._batch = None
        self._aux = {}
        f32_precision()
        if ckpt is not None:
            self.load(ckpt, cfg)
        else:
            self.build(cfg)

    # ------------------------------------------------------------------ build
    def build(self, cfg, pruned=None):
        """Nets and optimizers from `cfg`; the mask from `pruned` when given
        (a checkpoint's), else generated from cfg.mask and the seed."""
        if cfg is None:
            raise ValueError("CSModel needs a cfg or a checkpoint")
        if cfg.get("use_amp", False):
            raise NotImplementedError("the bf16 policy (use_amp) is not ported yet")
        # the JAX package's guard (its csmodel.py:286-293), after the
        # reference's own assert: the recipe was only validated at 1e-4
        if cfg.get("lr") != 1e-4:
            raise ValueError(
                f"lr={cfg.get('lr')}: the reference recipe pins lr to 1e-4"
            )
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
        # checkpoint entries (and opt_state keys) of nets the port does not
        # run, kept as loaded so that `save` writes them back
        self._carried = {}
        self._carried_opt = {}
        self.opt = {
            name: torch.optim.Adam(
                getattr(self, name).parameters(), lr=cfg.lr,
                betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
            )
            for name in ("net_T", "net_R")
        }
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

    def train(self, mode=True):
        """Allow (or, with False, refuse) `update`, as in the JAX package.
        The nets' own modes are set by each entry point."""
        self.training = mode
        return self

    def eval(self):
        return self.train(False)

    def _nets_mode(self, train: bool):
        """Put net_T and net_R in train or eval mode, only on a change: a
        `train()` walks all ~1000 modules, milliseconds of host time that
        the card would wait for at the start of every request."""
        for net in (self.net_T, self.net_R):
            if net.training != train:
                net.train(train)

    # ------------------------------------------------------------ checkpoint
    def _entries(self, name) -> list:
        if name == "net_T":
            return from_jax.stn_entries(self.net_T)
        return from_jax.varnet_entries_of(self.net_R)

    def load(self, ckpt, cfg=None):
        """Load a checkpoint directory the JAX `CSModel.save` (or `save`
        here) wrote."""
        loaded = ckpt_load(ckpt)
        saved_cfg = loaded.pop("config", None)
        self.build(cfg if cfg is not None else saved_cfg,
                   pruned=loaded.get("net_mask", {}).get("pruned"))
        self.load_entries(loaded)

    def load_entries(self, entries: dict):
        """Set weights from JAX checkpoint entries {'net_T': flat, ...}; a
        net whose weights load restarts its Adam, unless `opt_state` (the
        JAX package's `save(with_opt=True)` entry) restores the moments.
        net_G / net_D (not ported yet), net_mask's entries other than
        `pruned`, and the `opt_state` keys of nets other than net_T and
        net_R are kept as they are for `save`."""
        for name in entries:
            if name not in NET_NAMES and name != "opt_state":
                raise KeyError(f"unknown checkpoint entry {name!r}")
        for name in ("net_T", "net_R"):
            if name in entries:
                from_jax.load_from_jax(
                    getattr(self, name), entries[name], self._entries(name)
                )
                self.opt[name].state.clear()
        for name in ("net_G", "net_D"):
            if name in entries:
                self._carried[name] = dict(entries[name])
        mask_entry = entries.get("net_mask", {})
        self._carried["net_mask"] = {k: v for k, v in mask_entry.items()
                                     if k != "pruned"}
        if "pruned" in mask_entry:
            self.pruned = torch.as_tensor(
                np.asarray(mask_entry["pruned"]).astype(bool), device=self.device
            )
        if "opt_state" in entries:
            self._load_opt(entries["opt_state"])
            self._carried_opt = {k: v for k, v in entries["opt_state"].items()
                                 if k.split("/")[0] not in self.opt}

    def save(self, path, with_opt=False):
        """Write a checkpoint directory the JAX `CSModel` loads: net_T
        (params and BatchNorm stats), net_R, net_mask (`pruned`), the
        config, and net_G / net_D as loaded; with `with_opt`, the Adam
        moments of net_T and net_R as the JAX package lays out its
        `opt_state` (optax's mu, nu, count for torch's exp_avg,
        exp_avg_sq, step) beside the loaded `opt_state` of the other nets.

        The JAX `load` wants the optimizer state of every net it has. The
        port makes none for net_G and net_D (ROADMAP queue 1 item 3), so
        `with_opt` needs a loaded checkpoint that carried `opt_state`, and
        raises NotImplementedError otherwise."""
        if with_opt and not self._carried_opt:
            raise NotImplementedError(
                "save(with_opt=True) needs the opt_state of net_G, net_D and "
                "net_mask from a loaded checkpoint: the port does not build "
                "net_G and net_D yet (ROADMAP queue 1 item 3)"
            )
        ckpt = dict(self._carried)
        for name in ("net_T", "net_R"):
            sd = getattr(self, name).state_dict()
            tensors = {k: v for k, v in sd.items()
                       if not k.endswith("num_batches_tracked")}
            ckpt[name] = from_jax.to_jax_entries(tensors, self._entries(name))
        ckpt["net_mask"] = {**self._carried.get("net_mask", {}),
                            "pruned": self.pruned.cpu().numpy()}
        if with_opt:
            ckpt["opt_state"] = {**self._carried_opt, **self._opt_entries()}
        ckpt["config"] = self.cfg
        ckpt_save(ckpt, path)

    def _param_entries(self, name) -> list:
        return [e for e in self._entries(name) if e[1].startswith("params/")]

    def _opt_entries(self) -> dict:
        """Adam's state as `opt_state` keys 'net_X/0/count',
        'net_X/0/mu/<param path>', 'net_X/0/nu/<param path>'."""
        out = {}
        for name, opt in self.opt.items():
            params = dict(getattr(self, name).named_parameters())
            for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                tensors = {
                    tkey: opt.state[p][slot] if p in opt.state else torch.zeros_like(p)
                    for tkey, p in params.items()
                }
                entry = from_jax.to_jax_entries(tensors, self._param_entries(name))
                for jkey, a in entry.items():
                    out[f"{name}/0/{key}/{jkey[len('params/'):]}"] = a
            steps = [int(opt.state[p]["step"]) for p in params.values()
                     if p in opt.state]
            out[f"{name}/0/count"] = np.array(max(steps, default=0), np.int32)
        return out

    def _load_opt(self, flat: dict):
        """Restore Adam's state of net_T and net_R from an `opt_state`
        entry (the other nets' keys are for nets not ported yet)."""
        for name, opt in self.opt.items():
            prefix = f"{name}/0/"
            if prefix + "count" not in flat:
                raise KeyError(f"opt_state lacks {prefix}count")
            moments = {}
            for key in ("mu", "nu"):
                head = f"{prefix}{key}/"
                entry = {"params/" + k[len(head):]: v
                         for k, v in flat.items() if k.startswith(head)}
                moments[key] = from_jax.to_torch_tensors(
                    entry, self._param_entries(name)
                )
            step = float(np.asarray(flat[prefix + "count"]))
            opt.state.clear()
            for tkey, p in getattr(self, name).named_parameters():
                opt.state[p] = {
                    "step": torch.tensor(step),
                    "exp_avg": moments["mu"][tkey].to(p.device),
                    "exp_avg_sq": moments["nu"][tkey].to(p.device),
                }

    # ---------------------------------------------------------------- forward
    def _to_device(self, img_full, img_aux):
        img_full = torch.as_tensor(img_full, device=self.device).to(torch.complex64)
        img_aux = (
            torch.zeros_like(img_full) if img_aux is None
            else torch.as_tensor(img_aux, device=self.device).to(torch.complex64)
        )
        return img_full, img_aux

    def _prepare(self, img_full, img_aux, pruned):
        """set_input's undersampling with the fixed `pruned` vector."""
        img_k_full = fft2(img_full)
        img_k_sampled = masks_lib.apply_mask(img_k_full, pruned)
        img_sampled = ifft2(img_k_sampled)
        return {
            "img_full": img_full,
            "img_aux": img_aux,
            "img_k_full": img_k_full,
            "img_k_sampled": img_k_sampled,
            "img_sampled": img_sampled,
            "img_full_rss": rss(img_full),
            "img_sampled_rss": rss(img_sampled),
            "img_aux_rss": rss(img_aux),
        }

    def _forward_TR(self, env, stop_T=False):
        """net_T -> warp -> net_R; returns (offset, img_rec). With stop_T
        the offset and grid carry no gradient (regime None)."""
        aux_abs = env["img_aux"].abs()
        sampled_abs = env["img_sampled"].abs()
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_T):
            offset, grid = self.net_T(aux_abs, sampled_abs)
        img_warped = warp(aux_abs, grid)
        mask = torch.logical_not(self.pruned)[None, None, None, :]
        img_rec = self.net_R(
            env["img_k_sampled"], mask, img_warped, self.num_low_frequencies
        )
        return offset, img_rec

    def recon_step(self, img_full, img_aux):
        """The eval-mode serving computation on device tensors."""
        env = self._prepare(img_full, img_aux, self.pruned)
        return self._forward_TR(env)[1]

    def reconstruct(self, img_full, img_aux=None):
        """Serving path: undersample per the model's mask and reconstruct.

        img_full: complex [N, coils, H, W] fully-sampled image (numpy array
        or tensor); img_aux: the reference modality or None (zeros).
        Returns the reconstruction [N, 1, H, W] (real) on the model's device.
        """
        img_full, img_aux = self._to_device(img_full, img_aux)
        self._nets_mode(train=False)
        with torch.inference_mode():
            return self.recon_step(img_full, img_aux)

    # ---------------------------------------------------------------- train
    def set_input(self, img_full, img_aux=None):
        """The next training batch: complex [N, coils, H, W] fully sampled
        target and reference modality (None: zeros)."""
        self._batch = self._to_device(img_full, img_aux)

    def _regime_loss(self, env, regime):
        """The JAX package's `_regime_loss` for Rec and None; returns
        (total, losses)."""
        offset, img_rec = self._forward_TR(env, stop_T=(regime == "None"))
        losses = {
            "loss_smooth": gradient_loss(offset),
            "loss_sim": ssimloss(env["img_full_rss"], img_rec),
        }
        total = losses["loss_sim"] * self.cfg.weight_sim
        if regime != "None":
            total = total + losses["loss_smooth"] * self.cfg.weight_smooth
        losses["loss_all"] = total
        return total, losses

    def update(self):
        """One train step of regime cfg.reg on the batch of `set_input`:
        net_T's BatchNorm statistics update, the regime's nets take one
        Adam step."""
        if not self.training:
            raise RuntimeError("update() needs train mode (call train())")
        if self._batch is None:
            raise RuntimeError("update() needs a batch (call set_input())")
        regime = self.cfg.reg
        if regime in LATER_REGIMES:
            raise NotImplementedError(
                f"regime {regime!r} needs net_G and net_D, which a later "
                "slice of the port brings"
            )
        if regime not in GRAD_NETS:
            raise ValueError(f"unknown regime {regime!r}")
        if int(self.cfg.get("grad_accum", 1)) > 1:
            raise NotImplementedError(
                f"grad_accum={self.cfg.get('grad_accum')}: micro-batch gradient "
                "accumulation is not ported yet (ROADMAP queue 1 item 3)"
            )
        # the JAX package's condition (its csmodel.py:592)
        if self.cfg.get("mask") == "loupe" and bool(self.cfg.get("learn_mask", False)):
            raise NotImplementedError(
                "learn_mask with a LOUPE mask: mask learning is not ported yet "
                "(ROADMAP queue 1 item 6)"
            )
        self._nets_mode(train=True)
        env = self._prepare(*self._batch, self.pruned)
        total, losses = self._regime_loss(env, regime)
        for name in GRAD_NETS[regime]:
            self.opt[name].zero_grad(set_to_none=True)
        total.backward()
        for name in GRAD_NETS[regime]:
            self.opt[name].step()
        self._aux = {k: v.detach() for k, v in losses.items()}

    def get_vis(self, content="scalars"):
        """The last step's losses as {'scalars': {'loss_*': float}}."""
        if content != "scalars":
            raise NotImplementedError(
                f"get_vis({content!r}): only 'scalars' is ported yet"
            )
        return {"scalars": {k: float(v) for k, v in self._aux.items()
                            if k.startswith("loss_")}}
