"""Bicubic resampling of the trailing two axes (counterpart of the JAX
package's `ops/bicubic.py`).

The reference upsamples its 9x9 B-spline control grids with
`torch.nn.functional.interpolate(mode='bicubic', align_corners=False)`:
Keys' cubic kernel with a = -0.75, half-pixel centres, border taps
clamped (replicated). The JAX package reproduces that call with two
constant matrix products; here it is the call itself.
"""

import torch
import torch.nn.functional as F


def bicubic_resize2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic-resize the trailing two axes of `x` [..., h, w] to
    (out_h, out_w)."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(out_h, out_w),
                      mode="bicubic", align_corners=False)
    return y.reshape(*lead, out_h, out_w)
