"""mfu.serve: Serving's share of the chip's peak: net_T's and net_R's forward FLOPs a
slice (the frozen flops.py) times the unprofiled stretch's slices a
second, over the configuration's peak."""

from harness.readers import mfu

UNIT = "%"


def read(r):
    return mfu(r, 'serve')
