"""idle_between_ops_ms.train: Device-idle ms a step in the gaps whose innermost
host op on the window's thread is one of the program's `san.*` spans other than
`san.backward`, in the profiled sub-window."""

from harness.spans import idle_between_ops_ms

UNIT = "ms"


def read(r):
    return idle_between_ops_ms(r, 'train')
