"""CSModel: serving and the four train regimes (counterpart of the JAX
package's `engine/csmodel.py`).

Serving reconstructs a slice from its own undersampled k-space, guided by
a reference modality aligned to it:

    _prepare     fft2 -> apply the hard `pruned` mask (or, learning a
                 LOUPE mask, multiply by its soft sample) -> ifft2
    net_T        SpatialTransformer(|aux|, |sampled|) -> f32 grid
    warp         bilinear grid sample of |aux| (the CUDA kernel on a card)
    net_R        VarNet(k_sampled, mask, warped, num_low) -> rss image

Training (`set_input` -> `update` -> `get_vis("scalars")`) runs regime
cfg.reg, each net with its own Adam (the counterpart of the JAX package's
`optax.adamw(lr, weight_decay=0)`):

    None      net_R learns from loss_sim (the grid is detached)
    Rec       net_T and net_R learn from loss_sim * weight_sim +
              loss_smooth * weight_smooth
    Mixed     net_T, net_G and net_R learn from Rec's terms +
              loss_gan_sim * weight_gan_sim + loss_gan_G * weight_gan
    GAN-Only  net_T and net_G learn from loss_smooth, loss_gan_sim and
              loss_gan_G (net_R does not run)

loss_sim is the SSIM loss of the reconstruction against the fully sampled
rss image (the CUDA SSIM kernels on a card) and loss_smooth the
displacement field's smoothness. The GAN regimes run forwardG's crossover:
net_G synthesises the second half's target contrast from its reference,
which is warped (the d_img kernel's train path), and the first half's
warped reference is synthesised after the warp; loss_gan_sim is the L1
distance of the aligned synthesis to the target, loss_gan_G net_D's score
of it, through net_D but not into its weights. A second pass then steps
net_D on the detached fake and the real target (loss_gan_Dfake,
loss_gan_Dreal). BatchNorm statistics and spectral-norm vectors advance in
the JAX call order: net_T, net_G twice, net_D once, then net_D on the fake
and on the real image. With cfg.grad_accum > 1 the batch runs as that many
micro-batches (each TR/RT half split alike in the GAN regimes), their
gradients averaged into one step per net; BatchNorm statistics thread
through the micro-batches, spectral-norm vectors restart from the step's
own at each one.

Precision and memory (the JAX package's `cfg.use_amp` and remat): with
cfg.use_amp every net computes in bf16 (`self.dtype`; the convs cast
their inputs and weights, norms take f32 statistics), while parameters,
Adam state, BatchNorm statistics, spectral-norm vectors and checkpoints
stay f32; the k-space chain stays complex64, the STN's offset and grid
f32, and where f32 meets bf16 the result is f32 as in JAX (forwardG's
crossover concatenates f32 and bf16 images into f32 before the warp, so
the grid sample's backward kernels see f32 alone). cfg.net_R_remat
recomputes each cascade in the backward; it is off where the cfg does
not set it (the JAX package's default is on, chosen for a 16 GB TPU).
The f32 convs and matmuls run in true f32, or in TF32 at the JAX levels
"default" and "high" of `matmul_precision` (`set_matmul_precision`).
net_T's and net_G's training forwards are recomputed from a batch of
24 and a half batch of 12 up (`_remat_tg`), as in JAX; remat changes no
value (`models/remat.py` replays BatchNorm and spectral-norm updates).

Mask learning: with cfg.mask "loupe" and cfg.learn_mask, `_prepare`
multiplies the k-space by LOUPE's soft sample of net_mask's logits, so
that the None, Rec and Mixed steps also step net_mask (in None through
net_R alone: the grid is detached); the data-consistency mask stays the
step's hard `pruned`, which a hard sample of the updated logits replaces
after the step. `taylor_step` accumulates each line's Taylor saliency
(the squared gradient of loss_sim * weight_sim with respect to a per-line
k-space multiplier, nets in eval mode) and `prune` prunes by it, or by
|weight| for the other kinds (`masks.magnitude_prune`).

Evaluation (`eval` -> `set_input` -> `test` -> `get_vis`) runs the JAX
package's test step on a whole volume: net_T, the warp, forwardG's
crossover through net_G and net_R, all in eval mode, then the eval
metrics on the device (`utils/metrics_torch.py`): PSNR, SSIM, MAE and MSE
of the reconstruction, MI of the warped reference, against the fully
sampled rss image. loss_sim and metric_SSIM come from one launch of the
SSIM forward kernel. With `valid` (a bucketed volume padded with zero
slices) every scalar is a mean over the valid slices alone.

Nets are built from the cfg keys of the JAX `CSModel.build`, and
checkpoints go both ways in the JAX package's directory layout (`load`,
`save`), with weights, statistics and Adam moments carried by
`engine/from_jax.py`; `load` also reads the reference's own checkpoints
(raw state dicts, under the torch names the port's modules keep).
net_mask is `pruned` and, where the mask has one, its `weight` (LOUPE's
logits, a Taylor mask's saliency) with its own Adam state.

Data parallelism (the JAX package's `distribute` over a mesh, its
multi-host contract): `distribute(mesh)` (`parallel/mesh.py`) replicates
the model from rank 0 over a torch.distributed group. Then `set_input`
before `update` or `taylor_step` takes this rank's rows of the global
batch, and the step equals one process's step on the global batch: each
(micro-)batch's global rows are shared out over the ranks (each half of
forwardG's crossover cut apart, so that every rank keeps its own
crossover), BatchNorm takes the global batch's statistics, and the
gradients (Taylor's before they are squared) and the logged losses are
averaged over the group with one coalesced all_reduce. `reconstruct` and
the `set_input` before `test` take the whole batch on every rank: each
rank computes its share of the rows and every rank gets the whole
result. A batch whose rows do not divide over the ranks runs unsharded on
every rank, with a warning (none in `reconstruct`). Only rank 0 writes
checkpoints.

The model lives on `device`, "cuda" unless the caller asks for "cpu"; with
no card and no explicit "cpu" it raises rather than run on the CPU.
"""

import numpy as np
import torch

from ..models import remat
from ..models.gan import NetD, NetG, SpectralConv, loss_gan
from ..models.layers import set_compute_dtype, stat_dtype
from ..models.stn import SpatialTransformer, gradient_loss, gradient_loss_per_sample, warp
from ..models.unet_lib import BatchNorm2d
from ..models.varnet import VarNet
from ..ops import masks as masks_lib
from ..ops.fft import fft2, fftshift2, ifft2, rss
from ..ops.ssim import ssimloss
from ..parallel import mesh as mesh_lib
from ..utils import metrics_torch as metrics
from . import from_jax
from .checkpoint import ckpt_load, ckpt_save, is_reference_entry

NET_NAMES = ("net_mask", "net_G", "net_D", "net_T", "net_R")
NETS = ("net_G", "net_D", "net_T", "net_R")  # the modules CSModel builds

# which nets receive gradients per training regime (the JAX package's
# GRAD_NETS, engine/csmodel.py:121-126); net_D steps in its own pass
GRAD_NETS = {
    "None": ("net_R",),
    "Rec": ("net_T", "net_R"),
    "Mixed": ("net_T", "net_G", "net_R"),
    "GAN-Only": ("net_T", "net_G"),
}
GAN_REGIMES = ("Mixed", "GAN-Only")
# mask kinds whose fresh build has a `weight` (the JAX package keeps a
# reference checkpoint's net_mask weight for these alone, torch_compat.py:
# 287-291)
WEIGHTED_MASKS = ("mask", "loupe")
# regimes whose step also steps net_mask when a LOUPE mask learns (the ones
# that run net_R, whose loss reaches the logits)
MASK_REGIMES = ("None", "Rec", "Mixed")
# the kinds `prune` prunes by |weight| (a fixed mask by an all-ones one)
MAGNITUDE_MASKS = ("mask", "standard", "equispaced", "lowpass")


def _remat_tg(batch: int, threshold: int = 24) -> bool:
    """Whether a net_T (or, with threshold 12, net_G, which runs on half
    batches) training forward at `batch` is rematerialized: the JAX
    package's `_remat_tg` on its default, auto (csmodel.py:94-113)."""
    return batch >= threshold


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in float64 where it is (a float64 copy of the nets)."""
    return x.to(stat_dtype(x.dtype))


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


# the levels of JAX's `jax_default_matmul_precision`, which both JAX CLIs
# set from --matmul_precision
MATMUL_PRECISIONS = ("default", "high", "highest")


def set_matmul_precision(level=None):
    """The precision of the f32 convs (cuDNN) and matmuls (cuBLAS) at a
    JAX level, with JAX's meaning on a GPU: "default" and "high" compute
    them in TF32 (10 mantissa bits), "highest" in true f32. None, no level
    asked for, is the port's own policy, true f32 (`f32_precision`).
    Process-wide, like the switches themselves; the window ops keep their
    convs in f32 whatever is set (`ops/window.py::f32_convs`)."""
    if level is not None and level not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {level!r} is none of {MATMUL_PRECISIONS}")
    tf32 = level in ("default", "high")
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def f32_precision():
    """Run at true f32: cuDNN runs f32 convs in TF32 by default, which the
    JAX reference never does on the TPU; pin both switches off."""
    set_matmul_precision(None)


def _with_zero_chan(x):
    """cat a zero channel: net_D takes 2 channels, the second unused by the
    live path (the JAX package's `_with_zero_chan`)."""
    return torch.cat([x, torch.zeros_like(x)], dim=1)


class CSModel:
    """Facade owning the four nets, their optimizers and the k-space mask."""

    def __init__(self, cfg=None, ckpt=None, objects=None, device="cuda", seed=0,
                 matmul_precision=None):
        """From `cfg`, or from checkpoint `ckpt` (its own config unless
        `cfg` is given); `objects` names the nets to load from it, the
        others built fresh from `seed` (`load`). Sets the process's conv
        and matmul precision to `matmul_precision` (`set_matmul_precision`;
        None: true f32), so that a model built later without a level
        runs in f32 again."""
        self.device = resolve_device(device)
        self.seed = seed
        self.training = True
        self._batch = None
        self._aux = {}
        self.mesh = None
        self._dp_warned = set()
        set_matmul_precision(matmul_precision)
        if ckpt is not None:
            self.load(ckpt, cfg, objects)
        elif objects is not None:
            raise ValueError("objects names nets to load: it needs a checkpoint")
        else:
            self.build(cfg)

    # ------------------------------------------------------------------ build
    def build(self, cfg, pruned=None):
        """Nets and optimizers from `cfg`; the mask from `pruned` when given
        (a checkpoint's), else generated from cfg.mask and the seed."""
        if cfg is None:
            raise ValueError("CSModel needs a cfg or a checkpoint")
        # the JAX package's guard (its csmodel.py:286-293), after the
        # reference's own assert: the recipe was only validated at 1e-4
        if cfg.get("lr") != 1e-4:
            raise ValueError(
                f"lr={cfg.get('lr')}: the reference recipe pins lr to 1e-4"
            )
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.get("use_amp", False) else torch.float32
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
                # off unless the cfg sets it: the JAX package's default
                # (on) was chosen to fit a 16 GB TPU
                remat=bool(cfg.get("net_R_remat", False)),
            )
        # zero-init head => identity transform at init, as in training
        torch.nn.init.zeros_(self.net_T.head.weight)
        torch.nn.init.zeros_(self.net_T.head.bias)
        # net_G and net_D draw their xavier-normal weights and their u and v
        # from a generator of their own
        gan_gen = torch.Generator().manual_seed(
            int(torch.randint(2**31, (1,), generator=gen)))
        self.net_G = NetG(
            layers=tuple(cfg.get("net_G_layers", (64, 128, 256, 512, 512))),
            generator=gan_gen,
        )
        self.net_D = NetD(
            blocks=tuple(tuple(b) for b in cfg.get(
                "net_D_blocks",
                ((64,) * 2, (128,) * 2, (256,) * 2, (256,) * 2, (256,) * 2),
            )),
            generator=gan_gen,
        )
        for name in NETS:
            set_compute_dtype(getattr(self, name), self.dtype).to(self.device).eval()
        # the BatchNorms that take the global batch's statistics in a
        # sharded step (`_sync_bn`)
        self._bns = [m for name in NETS for m in getattr(self, name).modules()
                     if isinstance(m, BatchNorm2d)]
        self.opt = {name: self._adam(getattr(self, name)) for name in NETS}
        # the mask: its kind's slopes and fresh `weight` from the seed, as
        # the JAX package's build; `pruned` a checkpoint's where given
        self.mask = masks_lib.make_mask(
            cfg.mask, cfg.shape, cfg.get("sparsity"), seed=self.seed
        )
        self.net_mask = masks_lib.MaskNet()
        if self.mask.weight is not None:
            self._set_mask_weight(self.mask.weight)
        if pruned is None:
            pruned = self.mask.pruned
        self.pruned = torch.as_tensor(
            np.asarray(pruned).astype(bool), device=self.device
        )
        self._taylor_values = []
        # the draws of mask learning (the JAX package keys them from
        # PRNGKey(seed + 1)) and of `prune`'s jitter
        self._mask_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self._prune_rng = np.random.default_rng(self.seed)

    def _adam(self, module):
        return torch.optim.Adam(
            module.parameters(), lr=self.cfg.lr,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
        )

    def _set_mask_weight(self, weight):
        """Set net_mask's `weight`; the first time, create the parameter
        and its Adam (a fresh build of a weighted kind, or the slot a
        checkpoint or `prune` gives a Taylor mask, as the JAX package
        does)."""
        created = self.net_mask.weight is None
        self.net_mask.set_weight(weight)
        if created:
            self.net_mask.to(self.device)
            self.opt["net_mask"] = self._adam(self.net_mask)

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

    def distribute(self, mesh):
        """Data parallelism over `mesh` (`parallel/mesh.py::make_mesh`),
        the counterpart of the JAX `distribute`: the nets, their Adam
        state, the mask and `pruned` are broadcast from rank 0, so every
        rank holds rank 0's model. The model must live on the mesh's
        device. Then, as the JAX package's multi-host contract: `set_input`
        before `update` or `taylor_step` takes this rank's rows of the
        global batch (rank r's loader shard; in rank order the ranks' rows
        make the global batch), and the step is the global batch's;
        `reconstruct`, and `set_input` before `test`, take the whole batch
        on every rank, and every rank gets the whole result. Call it after
        the model is loaded: `load` builds new nets. Returns the model."""
        device = self.device
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device != torch.device(mesh.device):
            raise ValueError(f"the model lives on {self.device}, the mesh's rank on "
                             f"{mesh.device}")
        self.mesh = mesh
        mesh_lib.replicate_state(mesh, self)
        return self

    def _nets_mode(self, train: bool):
        """Put the nets in train or eval mode, only on a change: a
        `train()` walks all ~1000 modules, milliseconds of host time that
        the card would wait for at the start of every request."""
        for name in NETS:
            net = getattr(self, name)
            if net.training != train:
                net.train(train)

    # ------------------------------------------------------------ checkpoint
    def _entries(self, name) -> list:
        if name == "net_mask":
            return from_jax.mask_entries(self.net_mask)
        if name == "net_T":
            return from_jax.stn_entries(self.net_T)
        if name == "net_R":
            return from_jax.varnet_entries_of(self.net_R)
        return from_jax.snconv_entries(getattr(self, name))

    def load(self, ckpt, cfg=None, objects=None):
        """Load a checkpoint: a directory the JAX `CSModel.save` (or `save`
        here) wrote, or a reference checkpoint in any layout `ckpt_load`
        reads. `objects` names the nets to load (the JAX signature that
        `--load_nets` uses); the others keep their fresh build, and the
        optimizer state is restored only when `objects` is None."""
        loaded = ckpt_load(ckpt)
        saved_cfg = loaded.pop("config", None)
        if objects is not None:
            missing = [name for name in objects if name not in loaded]
            if missing:
                raise KeyError(f"{missing} not in checkpoint {ckpt}")
            loaded = {name: loaded[name] for name in objects}
        self.build(cfg if cfg is not None else saved_cfg,
                   pruned=loaded.get("net_mask", {}).get("pruned"))
        self.load_entries(loaded)

    def load_entries(self, entries: dict):
        """Set weights and statistics from checkpoint entries {'net_T':
        flat, ...}, each a JAX entry or a reference state dict; a net whose
        weights load restarts its Adam, unless `opt_state` (the JAX
        package's `save(with_opt=True)` entry) restores the moments.
        net_mask's entry is `pruned` and an optional `params/weight`, which
        creates the weight where the mask kind has none (a Taylor mask's
        saliency), as the JAX package's `load` does."""
        for name in entries:
            if name not in NET_NAMES and name != "opt_state":
                raise KeyError(f"unknown checkpoint entry {name!r}")
        for name in NETS:
            if name in entries:
                if is_reference_entry(entries[name]):
                    self._load_state_dict(name, entries[name])
                else:
                    from_jax.load_from_jax(
                        getattr(self, name), entries[name], self._entries(name)
                    )
                self.opt[name].state.clear()
        if "net_mask" in entries:
            self._load_mask(entries["net_mask"])
        if "opt_state" in entries:
            self._load_opt(entries["opt_state"])

    def _load_mask(self, entry: dict):
        """net_mask from a JAX entry or a reference state dict."""
        if is_reference_entry(entry):
            # the JAX package's mask_to_flax (torch_compat.py:223-230):
            # `pruned`, and `weight` where the mask kind has one
            weight = entry.get("weight")
            entry = {k: v for k, v in entry.items() if k == "pruned"}
            if weight is not None and self.cfg.get("mask") in WEIGHTED_MASKS:
                entry["params/weight"] = np.asarray(weight)
        unknown = set(entry) - {"pruned", "params/weight"}
        if unknown:
            raise KeyError(f"net_mask entry has arrays the mask lacks: {sorted(unknown)}")
        if "params/weight" in entry:
            self._set_mask_weight(entry["params/weight"])
        if "net_mask" in self.opt:
            self.opt["net_mask"].state.clear()
        if "pruned" in entry:
            self.pruned = torch.as_tensor(
                np.asarray(entry["pruned"]).astype(bool), device=self.device
            )

    def _load_state_dict(self, name, sd: dict):
        """Load a reference state dict into net `name` by its torch names
        (strict: a name the module lacks, or a tensor of the module the
        dict lacks, raises; a BatchNorm's `num_batches_tracked`, which
        nothing reads, may be absent)."""
        module = getattr(self, name)
        tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
        for key, buf in module.state_dict().items():
            if key.endswith("num_batches_tracked") and key not in tensors:
                tensors[key] = torch.zeros_like(buf)
        module.load_state_dict(tensors, strict=True)

    def save(self, path, objects=None, with_opt=False):
        """Write `checkpoint(objects, with_opt)` as a checkpoint directory
        the JAX `CSModel` loads; on a distributed model rank 0 alone
        writes (every rank holds the same state)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        ckpt_save(self.checkpoint(objects, with_opt), path)

    def checkpoint(self, objects=None, with_opt=False) -> dict:
        """The checkpoint entries {'net_X': flat dict, ..., 'config'}: the
        four nets (params, and the BatchNorm statistics and spectral-norm
        vectors as `stats`) and net_mask (`pruned`, and `params/weight`
        where the mask has one), or of the nets only those that `objects`
        names; with `with_opt`, every net's Adam moments as the JAX package
        lays out its `opt_state` (optax's mu, nu, count for torch's
        exp_avg, exp_avg_sq, step), zero where a net has not stepped."""
        names = NET_NAMES if objects is None else objects
        unknown = [name for name in names if name not in NET_NAMES]
        if unknown:
            raise KeyError(f"unknown nets {unknown}")
        ckpt = {}
        for name in NETS:
            if name in names:
                sd = getattr(self, name).state_dict()
                tensors = {k: v for k, v in sd.items()
                           if not k.endswith("num_batches_tracked")}
                ckpt[name] = from_jax.to_jax_entries(tensors, self._entries(name))
        if "net_mask" in names:
            ckpt["net_mask"] = {
                **from_jax.to_jax_entries(dict(self.net_mask.named_parameters()),
                                          self._entries("net_mask")),
                "pruned": self.pruned.cpu().numpy(),
            }
        if with_opt:
            ckpt["opt_state"] = self._opt_entries()
        ckpt["config"] = self.cfg
        return ckpt

    def _param_entries(self, name) -> list:
        return [e for e in self._entries(name) if e[1].startswith("params/")]

    def _opt_entries(self) -> dict:
        """Adam's state as `opt_state` keys 'net_X/0/count',
        'net_X/0/mu/<param path>', 'net_X/0/nu/<param path>' (net_mask
        without a weight: its count alone, 0, as a JAX build holds it)."""
        out = {"net_mask/0/count": np.array(0, np.int32)}
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
        """Restore every net's Adam state from an `opt_state` entry."""
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

    def _prepare(self, img_full, img_aux, pruned, soft=None):
        """set_input's undersampling: by the hard `pruned` vector, or by
        `soft` [N, W], LOUPE's soft sample, through which the gradient
        reaches the mask's logits."""
        img_k_full = fft2(img_full)
        if soft is None:
            img_k_sampled = masks_lib.apply_mask(img_k_full, pruned)
        else:
            img_k_sampled = img_k_full * soft[:, None, None, :]
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

    def _forward_TGR(self, env, with_G=False, with_R=True, stop_T=False,
                     images=False, shard=None) -> dict:
        """net_T -> warp [-> forwardG] [-> net_R]; returns {"offset",
        ["img_aligned",] ["img_rec"]}, and with `images` (the test step)
        also "img_warped" and "img_warped_rss" and, with G, "img_synth".
        With stop_T the offset and grid carry no gradient (regime None).

        forwardG is the JAX package's batch-halving crossover: net_G
        synthesises the second half's target contrast from its reference,
        T = G(aux_RT), which is warped with the first half's reference,
        R; then TR = G(R). img_aligned = cat([TR, RT]), the first half the
        first ceil(n / 2) rows. `shard` (n, n1, k): these rows are a
        rank's share of a global batch of n rows whose first half is n1
        rows, the first k of them here (a rank's own rows, or its
        `mesh_lib.split_rows` share)."""
        aux_abs = env["img_aux"].abs()
        sampled_abs = env["img_sampled"].abs()
        if shard is None:
            n = aux_abs.shape[0]
            shard = (n, (n + 1) // 2, (n + 1) // 2)
        n, n1_global, n1 = shard
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_T):
            offset, grid = self._net_forward(self.net_T, 24, n, aux_abs, sampled_abs)
        out = {"offset": offset}
        if with_R:
            img_warped = warp(aux_abs, grid)
            if images:
                out["img_warped"] = img_warped
                out["img_warped_rss"] = rss(img_warped)
        if with_G:
            aux_rss = env["img_aux_rss"]
            # under bf16, synth and G(R) are bf16 and each cat with f32 is f32
            synth = self._net_forward(self.net_G, 12, n - n1_global, aux_rss[n1:])
            warped_all = warp(torch.cat([aux_rss[:n1], synth]), grid)
            out["img_aligned"] = torch.cat(
                [self._net_forward(self.net_G, 12, n1_global, warped_all[:n1]),
                 warped_all[n1:]])
            if images:
                out["img_synth"] = torch.cat([warped_all[:n1], synth])
        if with_R:
            mask = torch.logical_not(self.pruned)[None, None, None, :]
            out["img_rec"] = self.net_R(
                env["img_k_sampled"], mask, img_warped, self.num_low_frequencies
            )
        return out

    @staticmethod
    def _net_forward(net, threshold, rows, *args):
        """net(*args); a training forward of a batch of `rows` rows (the
        global batch's, in a sharded step, as the JAX package's jitted
        step sees it: every rank decides alike) at `threshold` or more
        is rematerialized (`_remat_tg`)."""
        if net.training and torch.is_grad_enabled() and _remat_tg(rows, threshold):
            return remat.checkpoint(net, *args)
        return net(*args)

    def recon_step(self, img_full, img_aux):
        """The eval-mode serving computation on device tensors."""
        env = self._prepare(img_full, img_aux, self.pruned)
        return self._forward_TGR(env)["img_rec"]

    def reconstruct(self, img_full, img_aux=None):
        """Serving path: undersample per the model's mask and reconstruct.

        img_full: complex [N, coils, H, W] fully-sampled image (numpy array
        or tensor); img_aux: the reference modality or None (zeros).
        Returns the reconstruction [N, 1, H, W] (real) on the model's device.
        On a distributed model every rank passes the whole batch and gets
        the whole reconstruction: each computes its contiguous share of
        the rows, then the ranks gather them. A batch whose rows do not
        divide over the ranks runs unsharded on every rank, silently
        (any request size is expected here).
        """
        img_full, img_aux = self._to_device(img_full, img_aux)
        self._nets_mode(train=False)
        with torch.inference_mode():
            n = img_full.shape[0]
            if self.mesh is None or n % self.mesh.size:
                return self.recon_step(img_full, img_aux)
            rec = self.recon_step(mesh_lib.shard_batch(self.mesh, img_full),
                                  mesh_lib.shard_batch(self.mesh, img_aux))
            return mesh_lib.gather_rows(self.mesh, [rec])[0]

    # ---------------------------------------------------------------- train
    def set_input(self, img_full, img_aux=None):
        """The next batch: complex [N, coils, H, W] fully sampled target and
        reference modality (None: zeros). On a distributed model, before
        `update` or `taylor_step` this is this rank's rows of the global
        batch (its loader's shard; the ranks' rows in rank order make the
        global batch), before `test` the whole batch on every rank."""
        self._batch = self._to_device(img_full, img_aux)

    def _regime_loss(self, env, regime, shard=None):
        """The JAX package's `_regime_loss`, the G-phase loss: the weighted
        sim, smooth and gan_sim terms, and the generator's adversarial term
        through net_D (train mode: its spectral-norm vectors advance).
        Returns (total, losses, img_aligned or None)."""
        cfg = self.cfg
        with_G = regime in GAN_REGIMES
        with_R = regime in ("None", "Rec", "Mixed")
        out = self._forward_TGR(env, with_G, with_R, stop_T=(regime == "None"),
                                shard=shard)
        losses = {"loss_smooth": gradient_loss(out["offset"])}
        total = 0.0
        if with_R:
            losses["loss_sim"] = ssimloss(env["img_full_rss"], out["img_rec"])
            total = total + losses["loss_sim"] * cfg.weight_sim
        if regime != "None":
            total = total + losses["loss_smooth"] * cfg.weight_smooth
        if with_G:
            aligned = out["img_aligned"]
            losses["loss_gan_sim"] = torch.mean(torch.abs(aligned - env["img_full_rss"]))
            total = total + losses["loss_gan_sim"] * cfg.weight_gan_sim
            pred_fake = self.net_D(_with_zero_chan(aligned))
            losses["loss_gan_G"] = loss_gan(pred_fake, real=False, D_loss=False)
            total = total + losses["loss_gan_G"] * cfg.weight_gan
        losses["loss_all"] = total
        return total, losses, out.get("img_aligned")

    def _d_phase_loss(self, img_aligned, img_full_rss):
        """The second pass: net_D on the detached fake, then on the real
        image. Returns (total, loss_fake, loss_real)."""
        pred_fake = self.net_D(_with_zero_chan(img_aligned.detach()))
        pred_real = self.net_D(_with_zero_chan(img_full_rss))
        lf = loss_gan(pred_fake, real=False, D_loss=True)
        lr = loss_gan(pred_real, real=True, D_loss=True)
        return (lf + lr) * self.cfg.weight_gan, lf, lr

    def _step_grads(self, env, regime, params, shard=None):
        """One (micro-)batch's gradients {net: [grad a param]} and losses
        (`shard`: `_forward_TGR`'s). The G-phase differentiates the nets
        of `params` but net_D (net_D's weights get nothing from it, as in
        the JAX step); the D-phase, in the GAN regimes, net_D alone."""
        names = [name for name in params if name != "net_D"]
        total, losses, aligned = self._regime_loss(env, regime, shard)
        flat = [p for name in names for p in params[name]]
        grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
        out = {name: [next(grads) for _ in params[name]] for name in names}
        if aligned is not None:
            d_total, losses["loss_gan_Dfake"], losses["loss_gan_Dreal"] = (
                self._d_phase_loss(aligned, env["img_full_rss"]))
            out["net_D"] = list(torch.autograd.grad(d_total, params["net_D"]))
        for name in out:  # a parameter the loss does not reach: zero, as jax.grad
            out[name] = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params[name], out[name])]
        return out, losses

    @staticmethod
    def _micro_rows(n, accum, gan):
        """The rows of each of the `accum` micro-batches of a batch of n:
        consecutive rows, or in the GAN regimes slice i of each TR/RT
        half, so that each micro-batch pairs its halves as the full batch
        does."""
        if accum == 1:
            return [np.arange(n)]
        m = n // accum
        if not gan:
            return [np.arange(i * m, (i + 1) * m) for i in range(accum)]
        half, m2 = n // 2, m // 2
        return [np.concatenate([np.arange(i * m2, (i + 1) * m2),
                                half + np.arange(i * m2, (i + 1) * m2)])
                for i in range(accum)]

    def _global_rows(self):
        """(rows of the global batch, this rank's first global row, every
        rank's row count) of the batch of `set_input`."""
        n = self._batch[0].shape[0]
        if self.mesh is None:
            return n, 0, [n]
        counts = mesh_lib.row_counts(self.mesh, n)
        return sum(counts), sum(counts[:self.mesh.rank]), counts

    def _warn_unsharded(self, what, n):
        """The JAX package's one-time warning (its `_dp_active`), once a
        batch size an entry point."""
        if (what, n) not in self._dp_warned:
            self._dp_warned.add((what, n))
            print(f"WARNING: {what}: batch {n} does not divide over the "
                  f"{self.mesh.size} ranks; this batch runs UNSHARDED on every rank "
                  "(pick a divisible batch size)", flush=True)

    def _plan(self, total, offset, counts, accum, gan):
        """The train step's micro-batches [(full, aux, rows, shard)]: the
        global `rows` that this rank computes, their images, and
        `_forward_TGR`'s shard; and whether the step is sharded. Sharded
        (a distributed model whose ranks hold equal rows and whose
        micro-batches divide over them), each rank computes its own rows
        where the step is one batch: forwardG's work on a row depends
        only on the half it lies in, so a rank may hold rows of one half
        alone. Under grad_accum each rank computes its `split_rows` share
        of each micro-batch, gathering the global batch first, so that
        every rank holds as many rows of each micro-batch (the group's
        mean of the ranks' losses is the micro-batch's). Unsharded, every
        rank computes every row."""
        full, aux = self._batch
        micro = self._micro_rows(total, accum, gan)
        size = 1 if self.mesh is None else self.mesh.size
        sharded = (self.mesh is not None and len(set(counts)) == 1
                   and all(len(rows) % size == 0 for rows in micro))
        if self.mesh is not None and not sharded:
            self._warn_unsharded("update", total)
        local = np.arange(offset, offset + full.shape[0])
        if sharded and accum == 1:
            n1 = (total + 1) // 2
            k = int(np.clip(n1 - offset, 0, len(local)))
            return [(full, aux, local, (total, n1, k))], True
        steps = []
        for rows in micro:
            n1 = (len(rows) + 1) // 2
            idx, k = (mesh_lib.split_rows(rows, n1 if gan else len(rows), size)[self.mesh.rank]
                      if sharded else (rows, n1))
            steps.append((idx, (len(rows), n1, k)))
        if self.mesh is not None and not all(np.array_equal(i, local) for i, _ in steps):
            full, aux = mesh_lib.gather_rows(self.mesh, [full, aux], local, total)
            offset = 0
        plan = []
        for idx, shard in steps:
            if np.array_equal(idx, np.arange(offset, offset + full.shape[0])):
                plan.append((full, aux, idx, shard))
            else:
                t = torch.as_tensor(idx - offset, device=self.device)
                plan.append((full[t], aux[t], idx, shard))
        return plan, sharded

    def _sync_bn(self, on: bool):
        """Global-batch BatchNorm statistics over the mesh in every
        BatchNorm of the nets (on), or each process's own (off)."""
        for m in self._bns:
            m.mesh = self.mesh if on else None

    def _spectral_convs(self):
        return [m for name in ("net_G", "net_D")
                for m in getattr(self, name).modules() if isinstance(m, SpectralConv)]

    def _check_step(self, regime, accum):
        """The refusals of `update`, before anything moves. Returns
        `_global_rows()`: the checks hold the global batch."""
        if not self.training:
            raise RuntimeError("update() needs train mode (call train())")
        if self._batch is None:
            raise RuntimeError("update() needs a batch (call set_input())")
        if regime not in GRAD_NETS:
            raise ValueError(f"unknown regime {regime!r}")
        rows = self._global_rows()
        n = rows[0]
        if regime in GAN_REGIMES and n // accum < 2:
            # forwardG halves the batch: batch 1 would push an empty half
            # through net_G's BatchNorm and poison net_G with NaN while every
            # reported loss stays finite (the JAX package's guard)
            raise ValueError(
                f"{regime} regime needs >= 2 samples per (micro-)batch for the "
                f"forwardG crossover; got batch {n} with grad_accum {accum}"
            )
        if accum > 1:
            if bool(self.cfg.get("learn_mask", False)):
                raise ValueError("grad_accum does not route gradients to the LOUPE "
                                 "mask; disable learn_mask or grad_accum")
            if n % accum:
                raise ValueError(f"batch {n} does not split into {accum} micro-batches")
            if regime in GAN_REGIMES and (n // accum) % 2:
                raise ValueError(
                    f"GAN-regime micro-batches must be even for the forwardG "
                    f"crossover: batch {n} / accum {accum} = {n // accum}")
        return rows

    def _mask_draws(self, n, draws):
        """The thresholds of a learned-mask step, on the model's device:
        `draws` (soft [n, W], hard [1, W]) where the caller gives them,
        else drawn from the model's generator; n is the global batch's
        rows (every rank draws them all, from the same generator state,
        and takes its own)."""
        w = self.cfg.shape
        if draws is None:
            return (torch.rand((n, w), generator=self._mask_gen, device=self.device),
                    torch.rand((1, w), generator=self._mask_gen, device=self.device))
        soft, hard = (torch.as_tensor(d, device=self.device) for d in draws)
        if soft.shape != (n, w) or hard.shape != (1, w):
            raise ValueError(f"mask draws of shapes {tuple(soft.shape)} and "
                             f"{tuple(hard.shape)}, expected {(n, w)} and {(1, w)}")
        return soft, hard

    def _loupe_sample(self, batch, training, thresh):
        return masks_lib.loupe_sample(
            self.net_mask.weight, self.cfg.sparsity, self.mask.pmask_slope,
            self.mask.sample_slope, batch=batch, training=training, thresh=thresh)

    def update(self, draws=None):
        """One train step of regime cfg.reg on the batch of `set_input`:
        the regime's nets take one Adam step on the G-phase's gradients
        and, in the GAN regimes, net_D one on the D-phase's, averaged over
        cfg.grad_accum micro-batches; BatchNorm statistics and spectral-norm
        vectors advance as they run. Learning a LOUPE mask, the batch is
        undersampled by its soft sample against the thresholds draws[0]
        ([N, W]), net_mask steps with the regime's nets (None, Rec,
        Mixed), and then `pruned` is the hard sample of the updated logits
        against draws[1] ([1, W]); without `draws`, the thresholds come
        from the model's generator (seeded by seed + 1). On a distributed
        model the batch is this rank's rows, `draws` the global batch's
        (the same on every rank), and the step the global batch's."""
        regime = self.cfg.reg
        accum = int(self.cfg.get("grad_accum", 1))
        total, offset, counts = self._check_step(regime, accum)
        gan = regime in GAN_REGIMES
        # the JAX package's condition (its csmodel.py:591)
        learn = self.cfg.get("mask") == "loupe" and bool(self.cfg.get("learn_mask", False))
        names = GRAD_NETS[regime] + (("net_mask",) if learn and regime in MASK_REGIMES else ())
        names += ("net_D",) if gan else ()
        params = {name: list(getattr(self, name).parameters()) for name in names}
        if learn:
            soft_thresh, hard_thresh = self._mask_draws(total, draws)
        elif draws is not None:
            raise ValueError("mask draws given, but the step learns no mask")
        plan, sharded = self._plan(total, offset, counts, accum, gan)
        self._nets_mode(train=True)
        sn_start = ([(m.weight_u.clone(), m.weight_v.clone()) for m in self._spectral_convs()]
                    if accum > 1 else None)
        sums, step_losses = None, []
        self._sync_bn(sharded)
        try:
            for full, aux, rows, shard in plan:
                if sn_start is not None:  # each micro-batch from the step's u, v
                    for m, (u, v) in zip(self._spectral_convs(), sn_start):
                        m.weight_u.copy_(u)
                        m.weight_v.copy_(v)
                soft = None
                if learn:
                    thresh = soft_thresh[torch.as_tensor(rows, device=self.device)]
                    soft = self._loupe_sample(len(rows), True, thresh)[0]
                grads, losses = self._step_grads(self._prepare(full, aux, self.pruned, soft),
                                                 regime, params, shard)
                step_losses.append({k: v.detach() for k, v in losses.items()})
                sums = grads if sums is None else {
                    name: [a + b for a, b in zip(sums[name], grads[name])] for name in sums}
        finally:
            self._sync_bn(False)
        self._aux = {k: torch.stack([sl[k] for sl in step_losses]).mean()
                     for k in step_losses[0]}
        if self.mesh is not None:  # XLA's psum: the global batch's gradients and losses
            mesh_lib.all_reduce_mean(
                self.mesh, [g for name in names for g in sums[name]] + list(self._aux.values()))
        for name in names:
            for p, g in zip(params[name], sums[name]):
                p.grad = g / accum if accum > 1 else g
            self.opt[name].step()
        if learn:  # the next step's data-consistency mask
            with torch.no_grad():
                self.pruned = self._loupe_sample(1, False, hard_thresh)[1]

    # ------------------------------------------------------------- pruning
    def taylor_step(self):
        """Accumulate the Taylor saliency of the batch of `set_input`: for
        each k-space line, the squared gradient of loss_sim * weight_sim
        with respect to a multiplier of that line (1 here), the nets in
        eval mode (no BatchNorm statistic or spectral-norm vector moves).
        The vectors stay on the device until `prune`. On a distributed
        model the batch is this rank's rows: the gradient is averaged over
        the group before it is squared, so that it is the global batch's
        (the mean of the ranks' squares would be another number)."""
        if self.cfg.get("mask") != "taylor":
            raise ValueError(f"taylor_step needs a taylor mask, not {self.cfg.get('mask')!r}")
        if self._batch is None:
            raise RuntimeError("taylor_step() needs a batch (call set_input())")
        full, aux = self._batch
        sharded = self.mesh is not None
        if sharded:
            total, offset, counts = self._global_rows()
            if len(set(counts)) > 1:
                self._warn_unsharded("taylor_step", total)
                sharded = False
                full, aux = mesh_lib.gather_rows(
                    self.mesh, [full, aux], np.arange(offset, offset + full.shape[0]), total)
        self._nets_mode(train=False)
        mask_vec = torch.ones(self.cfg.shape, dtype=full.real.dtype, device=self.device,
                              requires_grad=True)
        keep = (1.0 - self.pruned.to(full.real.dtype)) * mask_vec
        img_k_sampled = fft2(full) * keep[None, None, None, :]
        env = {"img_aux": aux, "img_k_sampled": img_k_sampled,
               "img_sampled": ifft2(img_k_sampled)}
        out = self._forward_TGR(env)
        loss = ssimloss(rss(full), out["img_rec"]) * self.cfg.weight_sim
        (grad,) = torch.autograd.grad(loss, mask_vec)
        if sharded:
            mesh_lib.all_reduce_mean(self.mesh, [grad])
        self._taylor_values.append((grad * grad).detach())

    def prune(self, num, thres=1.0, random=0.0):
        """Prune `num` more k-space lines by the mask kind's policy: the
        smallest |weight| below `thres` for 'mask' and the fixed kinds
        (these an all-ones weight unless a checkpoint gave one; jitter of
        up to `random` from a generator seeded once by the seed); the
        smallest mean Taylor saliency since the last prune for 'taylor'
        (which also becomes net_mask's weight, as in the reference); none
        for 'loupe', whose logits set its mask."""
        kind = self.cfg.get("mask")
        pruned = self.pruned.cpu().numpy()
        if kind in MAGNITUDE_MASKS:
            w = self.net_mask.weight
            weight = (w.detach().cpu().numpy() if w is not None
                      else np.ones(self.cfg.shape, np.float32))
            new = masks_lib.magnitude_prune(weight, pruned, num, thres, random,
                                            rng=self._prune_rng)
        elif kind == "taylor":
            values, self._taylor_values = self._taylor_values, []
            if num == 0:
                return
            if num < 0 or not values:
                raise ValueError(f"taylor prune of {num} lines over {len(values)} "
                                 "saliency vectors (call taylor_step first)")
            # the mean and the order in numpy, as the JAX package (ties too)
            w = np.stack([v.cpu().numpy() for v in values], 0).mean(0)
            w[pruned] = w.max()
            new = pruned.copy()
            new[np.argsort(w)[:num]] = True
            self._set_mask_weight(w)
        elif kind == "loupe":
            return
        else:
            raise ValueError(f"mask kind {kind!r} does not prune")
        self.pruned = torch.as_tensor(new, device=self.device)

    # ---------------------------------------------------------------- eval
    def _test_images(self, img_full, img_aux, shard=None):
        """The JAX package's test step (`_make_test_step_fn`,
        csmodel.py:824-886) on device tensors, up to its scalars: the
        eval-mode forward with net_G and net_R (`shard`: `_forward_TGR`'s),
        its images {'img_*'} and each slice's values of the eval scalars,
        in at least f32 as the JAX test step casts them."""
        env = self._prepare(img_full, img_aux, self.pruned)
        out = self._forward_TGR(env, with_G=True, with_R=True, images=True, shard=shard)
        full, rec, warped = (at_least_f32(env["img_full_rss"]), at_least_f32(out["img_rec"]),
                             at_least_f32(out["img_warped_rss"]))
        mask = (1.0 - self.pruned.to(torch.float32))[None, None, None, :]
        images = {
            "img_full_rss": full,
            "img_sampled_rss": env["img_sampled_rss"],
            "img_aux_rss": env["img_aux_rss"],
            "img_mask": fftshift2(mask.expand(full.shape)),
            "img_offset": out["offset"],
            "img_warped": out["img_warped"],
            "img_warped_rss": warped,
            "img_synth": out["img_synth"],
            "img_aligned": out["img_aligned"],
            "img_rec": rec,
        }
        per_slice = {
            "ssim": metrics.ssim_per_slice(full, rec),  # the one SSIM launch
            "smooth": gradient_loss_per_sample(out["offset"]),
            "gan_sim": torch.mean(torch.abs(at_least_f32(out["img_aligned"]) - full),
                                  dim=(1, 2, 3)),
            "mi": metrics.mi_per_slice(full, warped),
            "mse": metrics.mse_per_slice(full, rec),
            "mae": metrics.mae_per_slice(full, rec),
        }
        return images, per_slice

    @staticmethod
    def _test_scalars(per_slice, valid=None) -> dict:
        """The eval scalars from each slice's values. `valid` [N] (1 a real
        slice, 0 a pad slice) makes every scalar a mean over the real
        slices; a pad slice's values are dropped, not weighted by 0, so
        that a NaN there cannot reach the sums."""
        # one path for a whole volume and a padded one: valid None is all
        # ones, and every scalar a mean of per-slice values over the real
        # slices
        ssim = per_slice["ssim"]
        w = (torch.ones(ssim.shape[0], device=ssim.device) if valid is None
             else valid.to(torch.float32))
        real = w > 0
        n = torch.sum(w)

        def wmean(values):
            return torch.sum(torch.where(real, values * w, 0.0)) / n

        aux = {"metric_SSIM": wmean(ssim)}
        aux["loss_sim"] = 1.0 - aux["metric_SSIM"]
        aux["loss_smooth"] = wmean(per_slice["smooth"])
        aux["loss_gan_sim"] = wmean(per_slice["gan_sim"])
        aux["metric_MI"] = wmean(per_slice["mi"])
        aux["metric_MSE"] = wmean(per_slice["mse"])
        aux["metric_PSNR"] = 10.0 * torch.log10(1.0 / aux["metric_MSE"])
        aux["metric_MAE"] = wmean(per_slice["mae"])
        return aux

    def _test_step(self, img_full, img_aux, valid=None) -> dict:
        """The test step of one process on a whole batch: its images and
        its scalars (`_test_scalars`)."""
        images, per_slice = self._test_images(img_full, img_aux)
        return {**images, **self._test_scalars(per_slice, valid)}

    def _test_sharded(self, img_full, img_aux, valid=None) -> dict:
        """The test step of a distributed model on the whole batch: this
        rank's `split_rows` share, whose images and per-slice values the
        ranks gather, then the scalars of the whole batch on every rank."""
        n = img_full.shape[0]
        n1 = (n + 1) // 2
        idx, k = mesh_lib.split_rows(np.arange(n), n1, self.mesh.size)[self.mesh.rank]
        t = torch.as_tensor(idx, device=self.device)
        images, per_slice = self._test_images(img_full[t], img_aux[t], (n, n1, k))
        keys = list(images) + list(per_slice)
        whole = dict(zip(keys, mesh_lib.gather_rows(
            self.mesh, [*images.values(), *per_slice.values()], t, n)))
        return {**{k: whole[k] for k in images},
                **self._test_scalars({k: whole[k] for k in per_slice}, valid)}

    def test(self, valid=None, sync=True):
        """Eval step on the batch of `set_input` (a whole volume). `valid`:
        an optional [N] slice-validity vector (numpy, or a tensor already
        on the model's device) for a volume padded to a bucket. Returns
        -metric_PSNR (-metric_MI for GAN-Only) as a float; with
        sync=False it returns None and reads nothing back, so that a
        caller can stage the next volume while this one computes. On a
        distributed model every rank passes the whole batch and gets the
        whole result: each computes its share of the slices, then the
        ranks gather them (a batch whose slices do not divide over the
        ranks runs unsharded on every rank, with a warning)."""
        if self.training:
            raise RuntimeError("test() needs eval mode (call eval())")
        if self._batch is None:
            raise RuntimeError("test() needs a batch (call set_input())")
        self._nets_mode(train=False)
        with torch.inference_mode():
            if valid is not None:
                valid = torch.as_tensor(valid, device=self.device)
            n = self._batch[0].shape[0]
            if self.mesh is not None and n % self.mesh.size == 0:
                self._aux = self._test_sharded(*self._batch, valid)
            else:
                if self.mesh is not None:
                    self._warn_unsharded("test", n)
                self._aux = self._test_step(*self._batch, valid)
        if not sync:
            return None
        key = "metric_MI" if self.cfg.get("reg") == "GAN-Only" else "metric_PSNR"
        return -float(self._aux[key])

    def get_vis(self, content=None):
        """The last step's results, as the JAX `get_vis` gives them:
        "scalars" {'loss_*' and 'metric_*': float} (one readback), "images"
        {'img_*': numpy array} (the real 4-D images of 1 or 3 channels of
        the last `test`), "histograms" {'weights': {'values': net_mask's
        weight}} where the mask has one (LOUPE's logits, a Taylor mask's
        saliency); None gives all three."""
        if content not in (None, "scalars", "images", "histograms"):
            raise ValueError(f"unknown get_vis content {content!r}")
        vis = {}
        if content in (None, "scalars"):
            keys = [k for k in self._aux if k.startswith(("loss_", "metric_"))]
            values = (torch.stack([self._aux[k].detach().reshape(()) for k in keys])
                      .cpu().tolist() if keys else [])
            vis["scalars"] = dict(zip(keys, values))
        if content in (None, "images"):
            vis["images"] = {
                k: v.detach().cpu().numpy() for k, v in self._aux.items()
                if k.startswith("img_") and v.ndim == 4 and v.shape[1] in (1, 3)
                and not v.is_complex()
            }
        if content in (None, "histograms"):
            vis["histograms"] = {}
            weight = self.net_mask.weight
            if weight is not None:
                vis["histograms"]["weights"] = {"values": weight.detach().cpu().numpy()}
        return vis
