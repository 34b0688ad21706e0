"""net_G_fwd_ms.train: Device ms a step of the kernels launched under the
program's `san.net_G` spans (net_G's two forwards), in the profiled sub-window."""

from harness.spans import device_ms

UNIT = "ms"


def read(r):
    return device_ms(r, 'train', 'san.net_G')
