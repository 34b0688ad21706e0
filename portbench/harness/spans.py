"""What the readers of the program's own record share: the `san.*` spans
that the port opens at its layer boundaries while a profiler records, and
its set-up seconds (`spatialalignmentnetwork_tpu_torch/utils/trace.py`).

Each function takes the run's `Readings` and the loop kind its metric
belongs to, and returns None where the run has nothing to read: another
kind of loop, no trace, or a program without the spans or the record (one
older than them), so that such a run's line leaves the metric out.
"""

from . import stats
from .trace import WINDOW

PREFIX = "san."
BACKWARD = "san.backward"


def device_ms(r, kind, span):
    """Device ms a request or step of the kernels launched under `span`
    (each launch's host op stack on its thread)."""
    if r.kind != kind or r.trace is None:
        return None
    s = r.trace.device_s(ops=[span])
    return s * 1e3 / r.units if s > 0 else None


def host_ms(r, kind, span):
    """Host ms a request or step inside `span` on the window's thread."""
    if r.kind != kind or r.trace is None:
        return None
    durs = [e["dur"] for e in r.trace.host if e["name"] == span and e.get("tid") == r.trace.tid]
    return sum(durs) * 1e-3 / r.units if durs else None


def named_gaps(trace):
    """[(name, seconds)] of every idle gap of the device in the window,
    each named as `Trace.idle_gaps` names one (the innermost host op of the
    window's thread at its midpoint), by one sweep over the host ops:
    `idle_gaps` scans the host ops once a gap, too slow for the tens of
    thousands of gaps of a traced train step."""
    gaps = stats.gaps([(b, e) for b, e, _, _ in trace.device], trace.start, trace.end)
    stacks = trace._launch_stacks(
        {i: ((b + e) / 2 * 1e6, trace.tid) for i, (b, e) in enumerate(gaps)})
    out = []
    for i, (b, e) in enumerate(gaps):
        inner = [n for n in stacks.get(i, ()) if n != WINDOW]
        out.append((inner[-1] if inner else "host, no profiled op", e - b))
    return out


def _idle_ms(r, kind, keep):
    """Device-idle ms a request or step in the gaps whose name `keep`
    takes; None where the window's thread opened no span of the program."""
    if r.kind != kind or r.trace is None:
        return None
    tr = r.trace
    if not any(e["name"].startswith(PREFIX) for e in tr.host if e.get("tid") == tr.tid):
        return None
    return sum(sec for name, sec in named_gaps(tr) if keep(name)) * 1e3 / r.units


def idle_between_ops_ms(r, kind):
    """Device-idle ms a request or step in the gaps whose innermost host op
    is one of the program's spans other than `san.backward`: the host in the
    program's own code between ops, not inside one."""
    return _idle_ms(r, kind, lambda n: n.startswith(PREFIX) and n != BACKWARD)


def idle_in_backward_ms(r, kind):
    """Device-idle ms a request or step in the gaps while the window's
    thread waits in `san.backward`: autograd's own thread dispatching the
    backward's ops."""
    return _idle_ms(r, kind, lambda n: n == BACKWARD)


def _setup():
    """The program's set-up record, or None for a program without one."""
    try:
        from spatialalignmentnetwork_tpu_torch.utils.trace import SETUP
    except ImportError:  # a program older than the record
        return None
    return SETUP


def model_build_s(r, kind):
    """Host seconds of the program's model build in this process: its
    set-up record's "build.*" phases (each net's construction, the copy to
    the device, the optimizers, the mask)."""
    setup = _setup() if r.kind == kind else None
    if setup is None:
        return None
    phases = [s for name, s in setup.items() if name.startswith("build.")]
    return sum(phases) if phases else None


def kernel_build_s(r, kind):
    """Host seconds of `nvcc` in this process: the set-up record's
    "kernel_build.<source>" phases; 0 where every kernel library was built
    before (the first run in a checkout builds them)."""
    setup = _setup() if r.kind == kind else None
    if setup is None:
        return None
    return sum(s for name, s in setup.items() if name.startswith("kernel_build."))
