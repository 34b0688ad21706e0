"""conv_ms.train: Device ms a step of the conv layer (layers/conv.json), forward and
backward, in the profiled sub-window."""

from harness.readers import conv_ms

UNIT = "ms"


def read(r):
    return conv_ms(r, 'train')
