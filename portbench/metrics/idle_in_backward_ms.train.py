"""idle_in_backward_ms.train: Device-idle ms a step in the gaps while the window's
thread waits in `san.backward` (autograd's thread dispatching the backward), in
the profiled sub-window."""

from harness.spans import idle_in_backward_ms

UNIT = "ms"


def read(r):
    return idle_in_backward_ms(r, 'train')
