"""dispatch_ms.serve: Host ms from the call of CSModel.reconstruct to its return, before the
readback, a request (the mean over the unprofiled stretch)."""

from harness.readers import dispatch_ms

UNIT = "ms"


def read(r):
    return dispatch_ms(r, 'serve')
