"""What the loops (`loops/<name>.py`) share: the base class a loop
subclasses, the benchmark's spans, CUDA event timers and the count of the
port's kernel launches in each phase of the profiled sub-window.

A loop module defines `LOOP`, a subclass of `Loop`, which the registry
finds by the module's name. The loop drives the program (`setup`,
`window`, `profiled`), states its own FLOPs a slice, the shapes of the
port's kernels in each of its phases and its reference, and gives the
numbers its check compares.
"""

import collections
import contextlib

import torch

from . import program


def span(name, on):
    """A profiler span of the benchmark's own, where `on`."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Events:
    """A CUDA event pair around a block."""

    def __enter__(self):
        self.a, self.b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        self.a.record()

    def __exit__(self, *exc):
        self.b.record()

    def ms(self):
        return self.a.elapsed_time(self.b)


class NetTimer:
    """CUDA events around every forward of the given nets (forward pre-
    and post-hooks): device ms a call, summed a net."""

    def __init__(self, nets: dict):
        self.events = {name: [] for name in nets}
        self.handles = []
        for name, net in nets.items():
            self.handles.append(net.register_forward_pre_hook(self._pre(name)))
            self.handles.append(net.register_forward_hook(self._post(name)))

    def _pre(self, name):
        def hook(module, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name].append([ev, None])
        return hook

    def _post(self, name):
        def hook(module, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name][-1][1] = ev
        return hook

    def close(self) -> dict:
        """Remove the hooks; {net: device ms summed over its calls}."""
        for h in self.handles:
            h.remove()
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in evs)
                for name, evs in self.events.items()}


class Launches:
    """The port's kernel launches in each phase, as the program counts
    them: {phase: Counter({kernel: launches})}."""

    def __init__(self):
        self.by_phase = {}

    @contextlib.contextmanager
    def phase(self, name, on=True):
        if not on:
            yield
            return
        before = program.launches()
        yield
        counts = self.by_phase.setdefault(name, collections.Counter())
        for k, v in program.launches().items():
            counts[k] += v - before.get(k, 0)


def model_widths(c: dict):
    """The frozen `flops.py`'s keywords for net_R and net_T of the
    configuration's `model` block."""
    net_r = dict(num_cascades=c["net_R_cascades"], sens_chans=c["net_R_sens_chans"],
                 sens_pools=c["net_R_sens_pools"], chans=c["net_R_chans"], pools=c["net_R_pools"])
    stn = dict(feat=c["net_T_layers"][0], layers=tuple(c["net_T_layers"]))
    return net_r, stn


class Loop:
    """A loop over the program. Subclasses set `kind` ("serve" or "train":
    the metrics a cell reports), `UNITS` (its end-to-end metrics' units)
    and `KERNEL_SHAPES`, {phase: {kernel: (channels, side)}}: the images
    each of the port's kernels works on in that phase of `profiled`,
    `side` a key of `sizes()`. The launches themselves are counted in the
    run (`launched`), so the work a kernel roofline reads follows the path
    the program took."""

    kind = None
    UNITS = {}
    KERNEL_SHAPES = {}

    def __init__(self, run):
        self.run = run
        self.batch = run.traffic["batch"]
        self.size = run.model_cfg["shape"]
        self.launched = Launches()
        self.marks = []

    def sizes(self) -> dict:
        return {"shape": self.size}

    def flops_per_slice(self) -> float:
        raise NotImplementedError

    def kernel_work(self) -> list:
        """The port's kernels' operations in the profiled sub-window, each
        {"op", "count", "batch", "channels", "side"}, from the launches
        counted there and the loop's shapes; a kernel with no shape in its
        phase is left out."""
        sizes = self.sizes()
        out = []
        for phase, counts in sorted(self.launched.by_phase.items()):
            shapes = self.KERNEL_SHAPES.get(phase, {})
            for op, n in sorted(counts.items()):
                if n and op in shapes:
                    channels, side = shapes[op]
                    out.append({"op": op, "count": n, "batch": self.batch,
                                "channels": channels, "side": sizes[side]})
        return out

    def free(self):
        del self.model
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()
