"""net_R_ms.serve: Device ms a request of net_R's forward (CUDA events in forward pre- and
post-hooks on model.net_R) over the unprofiled stretch."""

from harness.readers import net_ms

UNIT = "ms"


def read(r):
    return net_ms(r, 'serve', 'net_R')
