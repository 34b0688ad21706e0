"""Readback-anchored marginal timing (the counterpart of the JAX package's
`utils/timing.py`).

A CUDA call returns once its kernels are queued, not when they have run,
so a wall time is anchored on a device->host readback of a scalar
(`float(...)` of a CUDA tensor waits for every kernel queued before it on
the stream). The fixed cost of one measurement (the host's launches ahead
of the first kernel and the readback itself) is stripped by timing two
chain lengths and taking the margin: (t_2N - t_N) / N; min-of-repeats on
both lengths rejects scheduler noise. On CPU tensors the readback is the
value itself.
"""

import time

__all__ = ["readback_time", "marginal_time"]


def readback_time(fn, *args):
    """Wall time of fn(*args) anchored on a host readback of its scalar."""
    t0 = time.perf_counter()
    float(fn(*args))
    return time.perf_counter() - t0


def marginal_time(make_chain, args, iters, repeats=3):
    """Per-iteration time of the chain returned by make_chain(n).

    make_chain(n) must return a callable whose n-iteration chain ends in
    a device scalar (the readback anchor). Both lengths run once to warm
    up (kernel builds, cuDNN's plans, the allocator) before timing.
    """
    short, long = make_chain(iters), make_chain(2 * iters)
    float(short(*args)), float(long(*args))  # build + warm

    t_short = min(readback_time(short, *args) for _ in range(repeats))
    t_long = min(readback_time(long, *args) for _ in range(repeats))
    return max(t_long - t_short, 1e-9) / iters
