"""What the per-layer readers (`metrics/<name>.py`) share. Each function
takes the run's `Readings` and the loop kind its metric belongs to, and
returns None where the run has nothing to read for it: another kind of
loop, no trace, or no device time of the kernels it names.

`Readings` carries the unprofiled stretch's record (host clock, CUDA
events, the allocator's peak) and the profiled sub-window's `Trace`.
"""

import dataclasses

from . import stats
from .roofline import work_seconds


@dataclasses.dataclass
class Readings:
    kind: str
    stretch: dict
    trace: object
    units: int  # requests or steps in the profiled sub-window
    flops_per_slice: float  # the loop's own rule (loops/<name>.py)
    kernel_work: list  # the port's kernels' operations in the sub-window (Loop.kernel_work)
    peak_flops: float
    registry: object


def mfu(r, kind):
    if r.kind != kind:
        return None
    rate = r.stretch["slices_per_s" if kind == "serve" else "train_slices_per_s"]
    return stats.share_percent(r.flops_per_slice * rate, r.peak_flops)


def idle_share(r, kind):
    if r.kind != kind or r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s())


def dispatch_ms(r, kind):
    if r.kind != kind or not r.stretch.get("dispatch_ms"):
        return None
    d = r.stretch["dispatch_ms"]
    return sum(d) / len(d)


def peak_gib(r, kind):
    if r.kind != kind or "peak_bytes" not in r.stretch:
        return None
    return r.stretch["peak_bytes"] / 2 ** 30


def conv_ms(r, kind):
    """Device ms a request or step of the kernels launched under the conv
    ops of layers/conv.json, or named there."""
    if r.kind != kind or r.trace is None:
        return None
    names = r.registry.load("layers", "conv")
    s = r.trace.device_s(kernels=names["kernels"], ops=names["ops"])
    return s * 1e3 / r.units if s > 0 else None


def kernel_roofline(r, kind):
    """The port's kernels' operations launched in the profiled sub-window
    (counted there; bytes from the loop's shapes) at their bound, over the
    device time of those kernels (layers/kernels.json names them), in %."""
    if r.kind != kind or r.trace is None or not r.kernel_work:
        return None
    device = r.registry.load("layers", "kernels")["device"]
    s = r.trace.device_s(kernels=sorted({device[w["op"]] for w in r.kernel_work}))
    if s <= 0:
        return None
    return 100.0 * work_seconds(r.kernel_work) / s


def net_ms(r, kind, net):
    if r.kind != kind or "net_ms" not in r.stretch:
        return None
    return r.stretch["net_ms"][net]


def augment_ms(r, kind):
    if r.kind != kind or "augment_ms" not in r.stretch:
        return None
    return r.stretch["augment_ms"]
