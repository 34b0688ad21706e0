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
same `pruned` in both packages.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class MaskState:
    """State of a k-space mask.

    pruned: bool (W,) — True => line zeroed.
    weight: optional learnable parameter vector (the plain `mask` kind).
    kind:   registry name.
    """

    kind: str
    shape: int
    sparsity: Optional[float]
    pruned: np.ndarray
    weight: Optional[np.ndarray] = None


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


def make_mask(
    kind: str,
    shape: int,
    sparsity: Optional[float] = None,
    seed: Optional[int] = None,
) -> MaskState:
    """Build a MaskState by registry name.

    kinds: 'standard', 'equispaced', 'lowpass' (fixed, need sparsity);
           'mask', 'taylor' (start unpruned). A fresh 'loupe' build draws
           its first sample from JAX's generator and is not ported yet;
           serving takes `pruned` from the checkpoint instead.
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
        raise NotImplementedError(
            "a fresh LOUPE mask is not ported yet; load its `pruned` from "
            "a checkpoint"
        )
    raise ValueError(f"unknown mask kind: {kind!r}")


def apply_mask(kspace: torch.Tensor, pruned: torch.Tensor) -> torch.Tensor:
    """Zero pruned k-space lines: kspace [N,C,H,W] * (1 - pruned)[...,W]."""
    keep = 1.0 - pruned.to(torch.float32)
    return kspace * keep[None, None, None, :]
