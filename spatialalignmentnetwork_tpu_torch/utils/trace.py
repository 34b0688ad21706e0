"""The port traced from inside: named spans at its layer boundaries, and
the host seconds of its set-up.

`span(name)` marks one layer of a request or a train step. While a
`torch.profiler` records (`utils/profiler.trace`, the train CLI's
`--trace_at`, a benchmark's profiled window), it is
`torch.profiler.record_function(name)`: the span lands in the profiler's
trace beside the kernels, on one clock, so that each kernel is attributed
to the spans around its launch and each idle gap of the device to the span
the host was in. Otherwise it is one shared no-op context and calls no
profiler op (`record_function` itself goes through the dispatcher even
with no profiler running). Spans nest: a request's or a step's spans sit
under its outer span, `san.reconstruct` or `san.update`.

The spans (README, "Tracing the port"): san.reconstruct, san.to_device,
san.prepare, san.net_T, san.warp, san.net_G, san.net_R, san.net_D,
san.loss, san.backward, san.optimizer, san.update (`engine/csmodel.py`);
san.augment (`data/augment.py`); san.data_wait (`engine/train.py`).

`SETUP` holds what no profiler sees, the host seconds of set-up by phase
in the order first timed (`setup_timer`): each net's construction, the
nets' cast and copy to the device, the optimizers, the mask
(`CSModel.build`: "build.*"), and each kernel library's `nvcc` run
(`kernels.build`: "kernel_build.<source>"). It is always on: set-up runs
once. A phase timed twice in a process holds the sum.
"""

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()

SETUP = {}


def span(name: str):
    """`record_function(name)` while a profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def setup_timer(name: str):
    """Add the block's host seconds to SETUP[name]."""
    t = time.perf_counter()
    yield
    SETUP[name] = SETUP.get(name, 0.0) + time.perf_counter() - t


def reset():
    """Clear SETUP."""
    SETUP.clear()
