"""idle_share.train: The device's idle share of the profiled sub-window of train steps: one
minus the union of its kernels, copies and fills over the window."""

from harness.readers import idle_share

UNIT = "%"


def read(r):
    return idle_share(r, 'train')
