"""conv_ms.serve: Device ms a request of the conv layer (layers/conv.json) in the profiled
sub-window."""

from harness.readers import conv_ms

UNIT = "ms"


def read(r):
    return conv_ms(r, 'serve')
