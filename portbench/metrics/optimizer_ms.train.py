"""optimizer_ms.train: Device ms a step of the kernels launched under the
program's `san.optimizer` span (every net's Adam step), in the profiled sub-window."""

from harness.spans import device_ms

UNIT = "ms"


def read(r):
    return device_ms(r, 'train', 'san.optimizer')
