"""net_D_fwd_ms.train: Device ms a step of the kernels launched under the
program's `san.net_D` spans (net_D's three forwards: the G-phase's adversarial term, the
D-phase's fake and real passes), in the profiled sub-window."""

from harness.spans import device_ms

UNIT = "ms"


def read(r):
    return device_ms(r, 'train', 'san.net_D')
