"""The device trace of a profiled sub-window: `torch.profiler` (CPU and
CUDA) around a few requests or steps, its Chrome trace written under the
run's TMPDIR and read back here.

`Trace` answers what the per-layer readers ask: the window's length, the
device's busy time (the union of its kernels, copies and fills), the
device time of kernels by name or by the host ops they were launched
under (each launch's op stack on its thread, found through the launch's
correlation id), and the breakdown: the device ops that took most time
and the longest idle gaps, each named by the innermost host op that ran
meanwhile.
"""

import bisect
import json
import os
import tempfile

from . import stats

WINDOW = "portbench.subwindow"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def profile(fn, path):
    """Run fn() under the profiler inside the WINDOW span, synchronising
    before the span ends; write the trace to `path`; return its Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        return Trace.load(path)
    finally:
        os.remove(path)


class Trace:
    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X"]
        spans = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW} span")
        w = spans[0]
        self.start, self.end = w["ts"] * 1e-6, (w["ts"] + w["dur"]) * 1e-6
        self.tid = w.get("tid")
        self.device = [((e["ts"]) * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"],
                        e.get("args", {}).get("correlation"))
                       for e in xs if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]
        launches = {}
        for e in xs:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = (e["ts"], e.get("tid"))
        self._stacks = self._launch_stacks(launches)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def _launch_stacks(self, launches):
        """{correlation: (host op names enclosing the launch, outermost first)}
        by one sweep a thread over properly nested host spans."""
        by_tid = {}
        for e in self.host:
            by_tid.setdefault(e.get("tid"), []).append(
                (e["ts"], -e["dur"], e["ts"] + e["dur"], e["name"]))
        points = {}
        for corr, (ts, tid) in launches.items():
            points.setdefault(tid, []).append((ts, corr))
        out = {}
        for tid, pts in points.items():
            spans = sorted(by_tid.get(tid, []))
            stack, i = [], 0
            for ts, corr in sorted(pts):
                while i < len(spans) and spans[i][0] <= ts:
                    while stack and stack[-1][0] < spans[i][0]:
                        stack.pop()
                    stack.append((spans[i][2], spans[i][3]))
                    i += 1
                while stack and stack[-1][0] < ts:
                    stack.pop()
                out[corr] = tuple(name for _, name in stack)
        return out

    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return stats.union_seconds([(b, e) for b, e, _, _ in self.device], self.start, self.end)

    def device_s(self, kernels=(), ops=()) -> float:
        """Device seconds of the kernels whose name contains one of
        `kernels`, or that were launched under a host op named in `ops`."""
        ops = set(ops)
        total = 0.0
        for b, e, name, corr in self.device:
            if any(k in name for k in kernels) or ops.intersection(self._stacks.get(corr, ())):
                total += e - b
        return total

    def top_device_ops(self, k=10):
        sums = {}
        for b, e, name, _ in self.device:
            sums[name] = sums.get(name, 0.0) + (e - b)
        return sorted(([n, s] for n, s in sums.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The k longest idle gaps of the device in the window, each named
        by the innermost host op of the window's thread at its midpoint."""
        host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                      for e in self.host if e.get("tid") == self.tid and e["name"] != WINDOW)
        starts = [h[0] for h in host]
        out = []
        for b, e in stats.gaps([(d[0], d[1]) for d in self.device], self.start, self.end)[:k]:
            mid = (b + e) / 2
            inner = [h for h in host[: bisect.bisect_right(starts, mid)] if h[1] >= mid]
            label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host, no profiled op"
            out.append([label, e - b])
        return out


def trace_path(name: str) -> str:
    """A file for the trace under the run's TMPDIR, removed once read."""
    return os.path.join(tempfile.gettempdir(), f"portbench_{name}_{os.getpid()}.json")
