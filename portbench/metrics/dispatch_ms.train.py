"""dispatch_ms.train: Host ms of set_input and update, a step (the mean over the unprofiled
stretch)."""

from harness.readers import dispatch_ms

UNIT = "ms"


def read(r):
    return dispatch_ms(r, 'train')
