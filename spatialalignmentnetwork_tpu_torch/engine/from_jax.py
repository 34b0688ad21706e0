"""Carry weights over from the JAX package's checkpoints.

A JAX checkpoint entry for one network is a flat mapping of '/'-joined
flax paths, `params/...` and `stats/...` (what `engine/checkpoint.py`
reads). This module turns such an entry into the port module's
`state_dict`, so that both packages compute the same function. It is the
inverse of the JAX package's `engine/torch_compat.py`, and the port keeps
the reference torch names that module maps:

  * Conv kernels are HWIO in flax and OIHW in torch. A ConvTranspose kernel
    is also spatially FLIPPED: torch's transposed conv correlates with the
    flipped kernel relative to lax.conv_transpose.
  * The VarNet cascades are one `nn.scan`-ed block in flax, its params
    stacked on a leading axis of `num_cascades`; here they are unstacked
    into `cascades.{c}`.
  * fastMRI module numbering differs from execution order:
    `ConvBlock_{num_pools}` is the bottleneck (`conv`), and
    `up_conv.{last}.1` is the 1x1 head (`Conv_0`).
  * LibUNet's `Conv_k` / `BatchNorm_k` are numbered in call order through
    the recursion, which is the port's registration order; flax BatchNorm
    scale/bias/mean/var become weight/bias/running_mean/running_var.
  * NetG's and NetD's `SNConv_k` are numbered in call order too: each one's
    `BatchNorm_0` is its `bn`, its `SpectralConv_0` kernel and bias are the
    conv's `weight_orig` and `bias`, and the power-iteration vectors u and
    v (stats, torch's layout in both) are `weight_u` and `weight_v`.

An entry list holds (torch_key, jax_key, cascade_index or None, kind),
kind one of "conv", "convT", "same". The same lists carry the port's
tensors back (`to_jax_entries`), so the port writes checkpoints the JAX
package loads; the layout maps are permutations, so Adam's moments travel
with them exactly.
"""

import numpy as np
import torch
from torch import nn


def _fastmri_unet(torch_prefix, jax_prefix, num_pools, cascade=None):
    out = []

    def convblock(tp, jp):
        out.append((f"{tp}layers.0.weight", f"{jp}/Conv_0/kernel", cascade, "conv"))
        out.append((f"{tp}layers.3.weight", f"{jp}/Conv_1/kernel", cascade, "conv"))

    for i in range(num_pools):
        convblock(f"{torch_prefix}down_sample_layers.{i}.",
                  f"{jax_prefix}ConvBlock_{i}")
    convblock(f"{torch_prefix}conv.", f"{jax_prefix}ConvBlock_{num_pools}")
    for i in range(num_pools):
        out.append((
            f"{torch_prefix}up_transpose_conv.{i}.layers.0.weight",
            f"{jax_prefix}TransposeConvBlock_{i}/ConvTranspose_0/kernel",
            cascade, "convT",
        ))
        if i < num_pools - 1:
            convblock(f"{torch_prefix}up_conv.{i}.",
                      f"{jax_prefix}ConvBlock_{num_pools + 1 + i}")
    last = f"{torch_prefix}up_conv.{num_pools - 1}."
    convblock(f"{last}0.", f"{jax_prefix}ConvBlock_{2 * num_pools}")
    out.append((f"{last}1.weight", f"{jax_prefix}Conv_0/kernel", cascade, "conv"))
    out.append((f"{last}1.bias", f"{jax_prefix}Conv_0/bias", cascade, "same"))
    return out


def varnet_entries(num_cascades: int, sens_pools: int, pools: int) -> list:
    """Entries of a VarNet(use_ref) with the given depth."""
    entries = _fastmri_unet(
        "sens_net.norm_unet.unet.",
        "params/SensitivityModel_0/NormUnet_0/Unet_0/", sens_pools,
    )
    for c in range(num_cascades):
        entries += _fastmri_unet(
            f"cascades.{c}.model.unet.",
            "params/VarNetBlock_0/NormUnet_0/Unet_0/", pools, cascade=c,
        )
        entries.append((f"cascades.{c}.dc_weight",
                        "params/VarNetBlock_0/dc_weight", c, "same"))
    return entries


def stn_entries(module: nn.Module) -> list:
    """Entries of a SpatialTransformer, zipped in execution order: the
    LibUNet's convs and BatchNorms, then the head conv (flax `Conv_0` at
    the top level)."""
    convs = [n for n, m in module.named_modules() if isinstance(m, nn.Conv2d)]
    bns = [n for n, m in module.named_modules() if isinstance(m, nn.BatchNorm2d)]
    entries = []
    for i, name in enumerate(convs):
        slot = f"LibUNet_0/Conv_{i}" if i < len(convs) - 1 else "Conv_0"
        entries.append((f"{name}.weight", f"params/{slot}/kernel", None, "conv"))
        entries.append((f"{name}.bias", f"params/{slot}/bias", None, "same"))
    for i, name in enumerate(bns):
        entries += _bn_entries(name, f"LibUNet_0/BatchNorm_{i}")
    return entries


def _bn_entries(torch_name: str, slot: str) -> list:
    return [
        (f"{torch_name}.weight", f"params/{slot}/scale", None, "same"),
        (f"{torch_name}.bias", f"params/{slot}/bias", None, "same"),
        (f"{torch_name}.running_mean", f"stats/{slot}/mean", None, "same"),
        (f"{torch_name}.running_var", f"stats/{slot}/var", None, "same"),
    ]


def snconv_entries(module: nn.Module) -> list:
    """Entries of a NetG or NetD (models/gan.py), its SNConv modules
    zipped in call order with flax's `SNConv_k`."""
    from ..models.gan import SNConv

    entries = []
    snconvs = [(n, m) for n, m in module.named_modules() if isinstance(m, SNConv)]
    for k, (name, snconv) in enumerate(snconvs):
        slot = f"SNConv_{k}"
        if snconv.bn is not None:
            entries += _bn_entries(f"{name}.bn", f"{slot}/BatchNorm_0")
        conv = f"{slot}/SpectralConv_0"
        entries += [
            (f"{name}.conv.weight_orig", f"params/{conv}/kernel", None, "conv"),
            (f"{name}.conv.bias", f"params/{conv}/bias", None, "same"),
            (f"{name}.conv.weight_u", f"stats/{conv}/u", None, "same"),
            (f"{name}.conv.weight_v", f"stats/{conv}/v", None, "same"),
        ]
    return entries


def conv_entries(module: nn.Module) -> list:
    """Entries of a norm-free conv net (`models/unet_lib.py`'s Encoder,
    Decoder and ResNet): its Conv2d modules zipped in call order with
    flax's `Conv_k`."""
    convs = [n for n, m in module.named_modules() if isinstance(m, nn.Conv2d)]
    entries = []
    for k, name in enumerate(convs):
        entries.append((f"{name}.weight", f"params/Conv_{k}/kernel", None, "conv"))
        entries.append((f"{name}.bias", f"params/Conv_{k}/bias", None, "same"))
    return entries


def mask_entries(module: nn.Module) -> list:
    """Entries of net_mask (`ops/masks.py::MaskNet`): its `weight`, where
    the mask has one."""
    return [] if module.weight is None else [("weight", "params/weight", None, "same")]


def to_torch_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":  # HWIO -> OIHW
        return np.transpose(a, (3, 2, 0, 1))
    if kind == "convT":  # HWIO -> IOHW, spatially flipped
        return np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    if kind == "same":
        return a
    raise ValueError(f"unknown entry kind {kind!r}")


def to_jax_layout_shape(shape, kind: str) -> tuple:
    """The flax shape of a torch parameter of `shape` (one cascade)."""
    if kind == "conv":  # OIHW -> HWIO
        return (shape[2], shape[3], shape[1], shape[0])
    if kind == "convT":  # IOHW -> HWIO
        return (shape[2], shape[3], shape[0], shape[1])
    return tuple(shape)


def from_torch_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":  # OIHW -> HWIO
        return np.transpose(a, (2, 3, 1, 0))
    if kind == "convT":  # spatially flipped IOHW -> HWIO
        return np.transpose(a[:, :, ::-1, ::-1], (2, 3, 0, 1))
    if kind == "same":
        return a
    raise ValueError(f"unknown entry kind {kind!r}")


def to_torch_tensors(entry: dict, entries: list) -> dict:
    """A JAX entry -> {torch key: f32 tensor} (strict both ways: every
    entry of the list is found, every `params/` and `stats/` array of the
    entry is used)."""
    out = {}
    used = set()
    for tkey, jkey, cascade, kind in entries:
        if jkey not in entry:
            raise KeyError(f"JAX entry lacks {jkey} (for {tkey})")
        a = np.asarray(entry[jkey])
        if cascade is not None:
            a = a[cascade]
        # np.array copies: checkpoint arrays may be read-only views
        out[tkey] = torch.from_numpy(
            np.array(to_torch_layout(a, kind), dtype=np.float32)
        )
        used.add(jkey)
    unused = {k for k in entry if k.startswith(("params/", "stats/"))} - used
    if unused:
        raise KeyError(f"JAX entry has arrays the module lacks: {sorted(unused)[:5]}")
    return out


def to_jax_entries(tensors: dict, entries: list) -> dict:
    """The inverse of `to_torch_tensors`: {torch key: tensor} -> a JAX
    entry {jax key: f32 array}, the cascades stacked on a leading axis.
    Entries whose torch key is absent are skipped (Adam's moments exist
    for parameters only); every given tensor must be used."""
    out = {}
    stacks = {}
    used = set()
    for tkey, jkey, cascade, kind in entries:
        if tkey not in tensors:
            continue
        a = from_torch_layout(
            tensors[tkey].detach().to("cpu", torch.float32).numpy(), kind
        )
        used.add(tkey)
        if cascade is None:
            out[jkey] = np.ascontiguousarray(a)
        else:
            stacks.setdefault(jkey, {})[cascade] = a
    for jkey, parts in stacks.items():
        if sorted(parts) != list(range(len(parts))):
            raise KeyError(f"{jkey}: cascades {sorted(parts)} are not 0..n-1")
        out[jkey] = np.stack([parts[c] for c in range(len(parts))])
    unused = set(tensors) - used
    if unused:
        raise KeyError(f"tensors no entry maps: {sorted(unused)[:5]}")
    return out


def load_from_jax(module: nn.Module, entry: dict, entries: list):
    """Load a JAX checkpoint entry into `module` (strict both ways: every
    `params/` and `stats/` array of the entry is used, every parameter and
    running statistic of the module is set)."""
    sd = to_torch_tensors(entry, entries)
    for name, buf in module.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros_like(buf)
    module.load_state_dict(sd, strict=True)


def varnet_entries_of(module: nn.Module) -> list:
    """Entries of a VarNet module, its depths read from the module."""
    return varnet_entries(
        len(module.cascades),
        len(module.sens_net.norm_unet.unet.down_sample_layers),
        len(module.cascades[0].model.unet.down_sample_layers),
    )


def load_stn(module: nn.Module, entry: dict):
    load_from_jax(module, entry, stn_entries(module))


def load_varnet(module: nn.Module, entry: dict):
    load_from_jax(module, entry, varnet_entries_of(module))
