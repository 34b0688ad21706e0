"""Center crop-or-pad over the trailing two axes (the port's copy of the
JAX package's `ops/crop.py`).

Per axis: a smaller target center-crops, a larger one zero-pads; either
way the odd pixel goes to the trailing side. Works on numpy arrays (the
data pipeline, on the host) and on torch tensors (on their device), of any
leading rank.
"""

import numpy as np
import torch


def _window(size: int, target: int):
    """(source start, destination start, length) of one axis."""
    if target <= size:
        return (size - target) // 2, 0, target
    return 0, (target - size) // 2, size


def center_crop(data, shape):
    """Crop or zero-pad `data` so its last two dims equal `shape` (h, w)."""
    h_tgt, w_tgt = int(shape[0]), int(shape[1])
    sy, dy, ny = _window(data.shape[-2], h_tgt)
    sx, dx, nx = _window(data.shape[-1], w_tgt)
    src = data[..., sy:sy + ny, sx:sx + nx]
    if (ny, nx) == (h_tgt, w_tgt):
        return src
    if isinstance(data, np.ndarray):
        out = np.zeros((*data.shape[:-2], h_tgt, w_tgt), data.dtype)
    else:
        out = torch.zeros((*data.shape[:-2], h_tgt, w_tgt), dtype=data.dtype,
                          device=data.device)
    out[..., dy:dy + ny, dx:dx + nx] = src
    return out
