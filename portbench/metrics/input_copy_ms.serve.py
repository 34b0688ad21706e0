"""input_copy_ms.serve: Host ms a request inside the program's
`san.to_device` span (the inputs' copies to the card and their complex64 cast), in the
profiled sub-window."""

from harness.spans import host_ms

UNIT = "ms"


def read(r):
    return host_ms(r, 'serve', 'san.to_device')
