"""The plain reference of the two timed paths, serving and the Mixed train
step, in f32 (TF32 off) or, for the control, with every conv's input and
weight rounded to a lower precision (`precision.py`).

A frozen copy of `spatialalignmentnetwork_tpu_torch/engine/csmodel.py`'s
math at commit 3f2e19a (`_prepare`, `_forward_TGR`, `_regime_loss`,
`_d_phase_loss`, `update` for one batch), over the nets of `nets.py` and
the ops of `ops.py`, with one `torch.optim.Adam` a net. It imports nothing
of the port: the benchmark hands it the weights, the mask's seed, the
inputs and the augmentation draws, and it works out everything else.
"""

import contextlib

import torch

from . import nets as nets_lib
from .precision import ROUNDINGS
from .ops import equispaced_pruned, fft2, gradient_loss, ifft2, rss, ssim_loss, warp

TRAINED = ("net_T", "net_G", "net_R")  # the Mixed regime's G-phase nets


@contextlib.contextmanager
def true_f32():
    """cuDNN and cuBLAS in true f32 (no TF32) inside, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Reference:
    """The four nets of `model_cfg` loaded with `state` ({net: state
    dict}); the equispaced mask of `mask_seed`; with `rounding`, a name
    of `precision.ROUNDINGS`, in that precision. `train_step` computes the
    regimes of REGIMES alone."""

    REGIMES = ("Mixed",)

    def __init__(self, model_cfg, state, mask_seed, device, rounding=None, train=False):
        if model_cfg["mask"] != "equispaced" or model_cfg["coils"] != 1:
            raise ValueError("the reference covers the equispaced mask, 1 coil")
        self.cfg = model_cfg
        with torch.device(device):
            self.nets = nets_lib.build(model_cfg, checkpoint_cascades=train)
        for name, net in self.nets.items():
            net.load_state_dict(state[name])
            nets_lib.set_quant(net, *(ROUNDINGS[rounding] if rounding else (None, None)))
        shape = model_cfg["shape"]
        self.pruned = torch.as_tensor(
            equispaced_pruned(model_cfg["sparsity"], shape, mask_seed), device=device)
        self.num_low = int(shape * model_cfg["sparsity"] * 0.32)
        self.opt = ({name: torch.optim.Adam(net.parameters(), lr=model_cfg["lr"],
                                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
                     for name, net in self.nets.items()} if train else None)

    def _prepare(self, full, aux):
        k_full = fft2(full)
        k_sampled = k_full * (1.0 - self.pruned.to(torch.float32))[None, None, None, :]
        sampled = ifft2(k_sampled)
        return {"aux": aux, "k_sampled": k_sampled, "sampled": sampled,
                "full_rss": rss(full), "aux_rss": rss(aux)}

    def _rec(self, env, grid_img):
        mask = torch.logical_not(self.pruned)[None, None, None, :]
        return self.nets["net_R"](env["k_sampled"], mask, grid_img, self.num_low)

    @torch.no_grad()
    def serve(self, full, aux):
        """The eval-mode reconstruction [N, 1, H, W] of complex [N, 1, H, W]
        target and reference images."""
        with true_f32():
            for net in self.nets.values():
                net.eval()
            env = self._prepare(full, aux)
            aux_abs = env["aux"].abs()
            _, grid = self.nets["net_T"](aux_abs, env["sampled"].abs())
            return self._rec(env, warp(aux_abs, grid))

    def train_step(self, full, aux):
        """One Mixed step on the batch: the G-phase (net_T, net_G through
        forwardG's crossover, net_R, net_D's score of the aligned image)
        and the D-phase (net_D on the detached fake and the real image),
        then one Adam step a net. Returns (loss_all, {net: {name: grad}})."""
        c = self.cfg
        with true_f32():
            for net in self.nets.values():
                net.train()
            env = self._prepare(full, aux)
            aux_abs = env["aux"].abs()
            offset, grid = self.nets["net_T"](aux_abs, env["sampled"].abs())
            warped = warp(aux_abs, grid)
            n = aux_abs.shape[0]
            n1 = (n + 1) // 2
            aux_rss, full_rss = env["aux_rss"], env["full_rss"]
            synth = self.nets["net_G"](aux_rss[n1:])
            warped_all = warp(torch.cat([aux_rss[:n1], synth]), grid)
            aligned = torch.cat([self.nets["net_G"](warped_all[:n1]), warped_all[n1:]])
            rec = self._rec(env, warped)
            d_in = torch.cat([aligned, torch.zeros_like(aligned)], dim=1)
            total = (ssim_loss(full_rss, rec) * c["weight_sim"]
                     + gradient_loss(offset) * c["weight_smooth"]
                     + torch.mean(torch.abs(aligned - full_rss)) * c["weight_gan_sim"]
                     + nets_lib.loss_gan(self.nets["net_D"](d_in), False, False) * c["weight_gan"])
            params = {name: dict(self.nets[name].named_parameters()) for name in TRAINED}
            flat = [p for name in TRAINED for p in params[name].values()]
            grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
            out = {name: {k: next(grads) for k in params[name]} for name in TRAINED}
            d = self.nets["net_D"]
            fake = d(torch.cat([aligned.detach(), torch.zeros_like(aligned)], dim=1))
            real = d(torch.cat([full_rss, torch.zeros_like(full_rss)], dim=1))
            d_total = (nets_lib.loss_gan(fake, False, True)
                       + nets_lib.loss_gan(real, True, True)) * c["weight_gan"]
            d_params = dict(d.named_parameters())
            out["net_D"] = dict(zip(d_params, torch.autograd.grad(d_total, list(d_params.values()))))
            for name, grads_of in out.items():
                for k, p in self.nets[name].named_parameters():
                    g = grads_of[k]
                    p.grad = torch.zeros_like(p) if g is None else g
                    grads_of[k] = p.grad
                self.opt[name].step()
            return total.detach(), out
