"""mfu.train: The train step's share of the chip's peak: the regime's FLOPs a slice
with no recomputation counted (the frozen flops.py) times the unprofiled
stretch's slices a second, over the configuration's peak."""

from harness.readers import mfu

UNIT = "%"


def read(r):
    return mfu(r, 'train')
