"""Image grids for training's visual dumps (the port's own copy of the JAX
package's `utils/visualize.py`).

The equivalent of torchvision's `save_image` as the reference's
train.py:242-247 uses it: tile a [N, 1|3, H, W] batch into a row-major
grid with padding, clamp to a value range, write a JPEG. PIL is imported
where a file is written: the machine that trains may not have it.
"""

import numpy as np


def make_grid(batch, nrow=4, padding=10, value_range=(0, 1), pad_value=0.5):
    """[N, C(1|3), H, W] -> [H', W', 3] uint8 grid, `nrow` images a row."""
    x = np.asarray(batch, dtype=np.float32)
    if x.ndim != 4 or x.shape[1] not in (1, 3):
        raise ValueError(f"make_grid takes [N, 1|3, H, W], got {x.shape}")
    lo, hi = value_range
    x = np.clip((x - lo) / (hi - lo), 0.0, 1.0)
    if x.shape[1] == 1:
        x = np.repeat(x, 3, axis=1)
    n, _, h, w = x.shape
    rows = (n + nrow - 1) // nrow
    grid = np.full((rows * h + (rows + 1) * padding, nrow * w + (nrow + 1) * padding, 3),
                   pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = np.transpose(x[i], (1, 2, 0))
    return (grid * 255).astype(np.uint8)


def save_image(batch, path, nrow=4, padding=10, value_range=(0, 1), pad_value=0.5):
    """Write `make_grid(batch, ...)` to `path` as a JPEG (quality 90)."""
    from PIL import Image

    Image.fromarray(make_grid(batch, nrow, padding, value_range, pad_value)).save(
        path, quality=90)
