"""Cartesian k-space undersampling masks (counterpart of the JAX package's
`ops/masks.py`).

1-D line masks over the width (phase-encoding) axis of k-space, broadcast
as [None, None, None, :] over [N, C, H, W] k-space:

  * `pruned` is a boolean (W,) vector; True => that k-space line is zeroed.
  * The FFT layout is corner-DC (no fftshift), so the fully-sampled
    low-frequency (ACS) region lives at the *borders* of the W axis:
    indices [0, center_len//2) and [center_len//2 - center_len, W).
  * The "standard" (fastMRI random) and "equispaced" masks keep a central
    fraction of sparsity*0.32 fully sampled.

Generation runs once on the host with `np.random.default_rng(seed)`, the
same generator and call order as the JAX package, so one seed gives the
same `pruned` in both packages (a fresh LOUPE build: the same logits; its
first hard sample is drawn here by torch, see `make_mask`).

LOUPE (learned probabilistic undersampling): `weight` holds one logit a
line; `loupe_pmask` maps them to keep probabilities whose mean is the
sparsity, and `loupe_sample` draws a soft (differentiable) or hard mask
from them against uniform thresholds that the caller passes or draws from
an explicit `torch.Generator`, never the global one. `MaskNet` is
net_mask, the module that holds a mask's `weight` as a parameter.
`magnitude_prune` is the numpy pruning policy of the learnable masks.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class MaskState:
    """State of a k-space mask.

    pruned: bool (W,) — True => line zeroed.
    weight: optional parameter vector: all ones for the plain `mask`
            kind, LOUPE's logits for `loupe` (learned with cfg.learn_mask).
    kind:   registry name.
    pmask_slope, sample_slope: LOUPE's sigmoid slopes.
    """

    kind: str
    shape: int
    sparsity: Optional[float]
    pruned: np.ndarray
    weight: Optional[np.ndarray] = None
    pmask_slope: float = 5.0
    sample_slope: float = 12.0


def center_len_for(sparsity: float, shape: int) -> int:
    """Number of fully-sampled low-frequency (ACS) lines:
    round(shape * sparsity * 0.32), the fastMRI convention."""
    return int(round(shape * sparsity * 0.32))


def _center_slice(center_len: int):
    """Slice selecting the NON-center region in corner-DC layout."""
    return slice(center_len // 2, center_len // 2 - center_len)


def standard_mask(sparsity: float, shape: int, rng: np.random.Generator) -> np.ndarray:
    """fastMRI-style random mask: ACS borders always kept, remaining lines
    drawn uniformly so the total kept count is floor(sparsity*shape)."""
    center_len = center_len_for(sparsity, shape)
    if not (center_len < shape and math.floor(sparsity * shape) >= center_len):
        raise ValueError(
            f"standard mask infeasible: shape={shape} sparsity={sparsity} "
            f"gives {center_len} ACS lines but only "
            f"{math.floor(sparsity * shape)} total kept lines"
        )
    other_ratio = (sparsity * shape - center_len) / (shape - center_len)
    prob = np.full(shape, 1.1)
    prob[_center_slice(center_len)] = other_ratio
    thresh = rng.random(shape)
    keep = np.argsort(-(prob - thresh))[: math.floor(sparsity * shape)]
    pruned = np.ones(shape, dtype=bool)
    pruned[keep] = False
    return pruned


def equispaced_mask(sparsity: float, shape: int, rng: np.random.Generator) -> np.ndarray:
    """ACS borders kept + equispaced lines with a random start offset."""
    center_len = center_len_for(sparsity, shape)
    pruned = np.zeros(shape, dtype=bool)
    sl = _center_slice(center_len)
    pruned[sl] = True
    remaining_cnt = math.floor(sparsity * shape - center_len)
    if remaining_cnt < 2:
        raise ValueError(
            f"equispaced mask infeasible: shape={shape} sparsity={sparsity} "
            f"leaves {remaining_cnt} non-ACS lines to place (needs >= 2)"
        )
    interval = int((shape - center_len - 1) // (remaining_cnt - 1))
    start_max = (shape - center_len) - ((remaining_cnt - 1) * interval + 1)
    start = int(rng.integers(0, start_max + 1))
    part = pruned[sl].copy()
    n = part.shape[0]
    # the comb is placed in a half-rolled frame: line positions end up
    # offset by (n+1)//2 mod n, as in the JAX package and the reference
    part = np.roll(part, n // 2)
    part[start : start + interval * remaining_cnt : interval] = False
    part = np.roll(part, (n + 1) // 2)
    pruned[sl] = part
    return pruned


def lowpass_mask(sparsity: float, shape: int, rng=None) -> np.ndarray:
    """Keep only the floor(shape*sparsity) lowest-frequency (border) lines."""
    center_len = math.floor(shape * sparsity)
    if center_len < 1:
        raise ValueError(
            f"lowpass mask with sparsity {sparsity} at width {shape} "
            "keeps 0 lines; increase sparsity or width"
        )
    pruned = np.zeros(shape, dtype=bool)
    pruned[_center_slice(center_len)] = True
    return pruned


def rescale_prob(x: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Rescale probabilities so that their mean is `sparsity` (LOUPE).

    Both branches of a `torch.where` are evaluated and both backwards run:
    where the sigmoid saturates (xbar == 1 in f32, every logit above about
    3.4 at slope 5) the branch not taken would divide by 1 - xbar = 0, and
    its zero gradient times that infinity is NaN. Each branch's
    denominator is therefore 1 where that branch is not taken (the JAX
    package's guard)."""
    xbar = torch.mean(x)
    up = xbar > sparsity
    safe_up = torch.where(up, xbar, 1.0)
    safe_dn = torch.where(up, 1.0, 1.0 - xbar)
    return torch.where(
        up,
        x * sparsity / safe_up,
        1 - (1 - x) * (1 - sparsity) / safe_dn,
    )


def loupe_init_weight(shape: int, pmask_slope: float, rng: np.random.Generator) -> np.ndarray:
    """LOUPE logit init: uniform in [eps, 1-eps] pushed through logit/slope."""
    eps = 0.01
    x = rng.random(shape) * (1 - eps * 2) + eps
    return (-np.log(1.0 / x - 1.0) / pmask_slope).astype(np.float32)


def loupe_pmask(weight: torch.Tensor, sparsity: float, pmask_slope: float) -> torch.Tensor:
    """Keep probabilities a line, their mean `sparsity`."""
    return rescale_prob(torch.sigmoid(weight * pmask_slope), sparsity)


def loupe_sample(
    weight: torch.Tensor,
    sparsity: float,
    pmask_slope: float,
    sample_slope: float,
    batch: int,
    training: bool,
    thresh: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Draw a soft or hard LOUPE mask against uniform thresholds [batch, W]:
    `thresh` when given, else drawn from `generator` (one of the two is
    required). Returns (mask [batch, W], pruned [W] bool of the first
    sample). The kept lines are those whose score pmask - thresh reaches
    the k-th largest, k = int(sparsity W + 0.5), ties included (a sort, as
    the JAX package; a top-k would drop ties). Training: the soft mask
    sigmoid(score * sample_slope), differentiable in `weight`; else the
    hard 0/1 mask of the kept lines."""
    shape = weight.shape[0]
    pmask = loupe_pmask(weight, sparsity, pmask_slope)
    k = int(sparsity * shape + 0.5)
    if k < 1:
        # the k-th largest with k = 0 would keep every line
        raise ValueError(
            f"loupe mask with sparsity {sparsity} at width {shape} keeps "
            "0 lines; increase sparsity or width"
        )
    if thresh is None:
        if generator is None:
            raise ValueError("loupe_sample needs `thresh` or a `generator`")
        thresh = torch.rand((batch, shape), generator=generator,
                            device=weight.device, dtype=pmask.dtype)
    score = pmask[None, :] - thresh.to(pmask.dtype)
    with torch.no_grad():
        kth = torch.sort(score, dim=-1, descending=True).values[:, k - 1:k]
        not_pruned = score >= kth
    pruned = torch.logical_not(not_pruned[0])
    if training:
        mask = torch.sigmoid(score * sample_slope)
    else:
        mask = not_pruned.to(pmask.dtype)
    return mask, pruned


def magnitude_prune(
    weight: np.ndarray,
    pruned: np.ndarray,
    num: int,
    thres: float = 1.0,
    random: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Magnitude pruning of a learnable mask (the reference's masks.py:
    17-38): prune at most `num` lines of smallest |w| below `thres`
    (lines already pruned, and those at or above `thres`, excluded); with
    `random` > 0 the order is jittered by uniform noise in [0, random)
    from `rng`."""
    if thres < 0 or random < 0 or num < 0:
        raise ValueError(f"magnitude_prune: thres {thres}, random {random} and "
                         f"num {num} must be >= 0")
    pruned = pruned.copy()
    if num == 0:
        return pruned
    w = np.abs(np.asarray(weight, dtype=np.float64)).copy()
    big = max(random, w.max()) + thres
    w[pruned] = big
    w[w >= thres] = big
    rand = (rng.random(w.shape) if rng is not None else np.zeros_like(w)) * random
    ind = np.argsort(w - rand)[:num]
    ind = ind[w[ind] < thres]
    pruned[ind] = True
    return pruned


def make_mask(
    kind: str,
    shape: int,
    sparsity: Optional[float] = None,
    seed: Optional[int] = None,
) -> MaskState:
    """Build a MaskState by registry name.

    kinds: 'standard', 'equispaced', 'lowpass' (fixed, need sparsity);
           'mask', 'taylor' (learnable/saliency, start unpruned);
           'loupe' (learnable probabilistic, needs sparsity).

    A fresh 'loupe' build has the JAX package's logits bit for bit (the
    same `rng.random` draws). Its first `pruned`, a hard sample as the
    reference's first forward sets it, is drawn against thresholds of a
    torch generator seeded by the same `rng.integers(0, 2**31)` that seeds
    the JAX package's threefry key, so the two packages' first samples
    differ; a checkpoint carries `pruned`, so a loaded model serves the
    same mask in both.
    """
    rng = np.random.default_rng(seed)
    if kind == "standard":
        return MaskState(kind, shape, sparsity, standard_mask(sparsity, shape, rng))
    if kind == "equispaced":
        return MaskState(kind, shape, sparsity, equispaced_mask(sparsity, shape, rng))
    if kind == "lowpass":
        return MaskState(kind, shape, sparsity, lowpass_mask(sparsity, shape))
    if kind == "mask":
        return MaskState(
            kind, shape, sparsity,
            np.zeros(shape, dtype=bool),
            weight=np.ones(shape, dtype=np.float32),
        )
    if kind == "taylor":
        return MaskState(kind, shape, sparsity, np.zeros(shape, dtype=bool))
    if kind == "loupe":
        pmask_slope, sample_slope = 5.0, 12.0
        weight = loupe_init_weight(shape, pmask_slope, rng)
        gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31)))
        _, pruned = loupe_sample(
            torch.from_numpy(weight), sparsity, pmask_slope, sample_slope,
            batch=1, training=False, generator=gen,
        )
        return MaskState(
            kind, shape, sparsity, pruned.numpy(),
            weight=weight, pmask_slope=pmask_slope, sample_slope=sample_slope,
        )
    raise ValueError(f"unknown mask kind: {kind!r}")


MASK_KINDS = ("mask", "taylor", "standard", "lowpass", "equispaced", "loupe")


class MaskNet(nn.Module):
    """net_mask: a mask's `weight` (the reference's name) as a parameter,
    for the kinds that have one, else no parameter at all. `pruned` lives
    on `CSModel`, which owns the step that refreshes it."""

    def __init__(self, weight=None):
        super().__init__()
        self.register_parameter("weight", None)
        if weight is not None:
            self.set_weight(weight)

    def set_weight(self, weight):
        """Create the `weight` parameter from `weight` (f32), or copy into
        the existing one (an optimizer that holds it keeps holding it)."""
        w = torch.as_tensor(np.asarray(weight, np.float32))
        if self.weight is None:
            self.weight = nn.Parameter(w.clone())
        else:
            with torch.no_grad():
                self.weight.copy_(w)


def apply_mask(kspace: torch.Tensor, pruned: torch.Tensor) -> torch.Tensor:
    """Zero pruned k-space lines: kspace [N,C,H,W] * (1 - pruned)[...,W]."""
    keep = 1.0 - pruned.to(torch.float32)
    return kspace * keep[None, None, None, :]
