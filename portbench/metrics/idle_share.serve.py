"""idle_share.serve: The device's idle share of the profiled sub-window of serving requests: one
minus the union of its kernels, copies and fills over the window."""

from harness.readers import idle_share

UNIT = "%"


def read(r):
    return idle_share(r, 'serve')
