"""One run of one cell: set-up, the measured window, with `--trace 1` the
per-layer readings, then the check against the reference, and the result.

The order inside a run: set-up (build, weights, pool, the cell's own
shapes warmed; `setup_s` ends here); the window of `seconds` (untraced:
the end-to-end metrics; traced: the same loop with CUDA events and
dispatch times, then a profiled sub-window); the device's peak memory is
read; the program's state is freed; the reference runs on the kept
answers or the checked steps. Nothing of JAX may be loaded by then.
"""

import json
import sys
import time
import zlib

import numpy as np
import torch

from . import check, program, readers, stats, trace as trace_lib
from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "spatialalignmentnetwork_tpu")


class Run:
    """The context a loop reads: the cell's pieces, the seed and device."""

    def __init__(self, cell: dict, seed: int, device):
        self.cell = cell
        self.config = cell["config"]
        self.model_cfg = cell["config"]["model"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.mask_seed = self.sub_seed("mask")

    def sub_seed(self, tag: str) -> int:
        """A seed of its own for each stream drawn from the run's seed."""
        ss = np.random.SeedSequence([self.seed % 2 ** 64, zlib.crc32(tag.encode())])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device="cuda",
             t0=None, registry=None, plant=None) -> dict:
    """What one run found: correct, the checks, attempted, the metrics
    {name: (value, unit)}, the device's peak and, traced, the Trace.
    `plant(model)` breaks the program under the run (the fault tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    registry = registry or Registry()
    run = Run(cell, seed, device)
    on_card = run.device.type == "cuda"
    loop = registry.loop(run.traffic["loop"])(run)
    loop.setup(plant)
    setup_s = time.perf_counter() - t0
    out = {"trace": None}
    program.reset_launches()
    if not traced:
        rec = loop.window(seconds)
        launches = program.launches()
        values = {**loop.end_to_end(rec), "setup_s": setup_s}
        metrics = {k: (v, loop.UNITS[k]) for k, v in values.items()}
    else:
        before = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rec = loop.window(seconds, timed=True)
        launches = program.launches()
        if on_card:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        tr = trace_lib.profile(loop.profiled, trace_lib.trace_path(cell["name"]))
        r = readers.Readings(loop.kind, rec, tr, loop.units(), loop.flops_per_slice(),
                             loop.kernel_work(), run.config["peak_flops"], registry)
        metrics = {}
        for name, (read, unit) in registry.readers().items():
            value = read(r)
            if value is not None:
                metrics[name] = (value, unit)
        out["trace"] = tr
        out["peak_before"] = before
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    out["attempted"] = rec.get("requests", rec.get("steps"))
    out["launches"] = {k: v / out["attempted"] for k, v in launches.items()}
    out["stretch"] = rec
    out["setup_marks"] = [(name, t - t0) for name, t in loop.marks]
    loop.free()
    ok, rows = check.judge(loop.check(), cell["workload"]["limits"])
    out.update(correct=ok, checks=rows, metrics=metrics)
    return out


def result_line(cell: dict, out: dict, device_name: str, count: int) -> dict:
    metrics = {k: {"value": v, "unit": unit} for k, (v, unit) in out["metrics"].items()}
    dev = {"platform": "gpu", "kind": device_name, "count": count,
           "memory_peak_bytes": max(out["memory_peak_bytes"], out.get("peak_before", 0))}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": 0 if out["correct"] else out["attempted"],
            "metrics": metrics, "device": dev}
    tr = out["trace"]
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        line["breakdown"] = {"device_ops": tr.top_device_ops(10), "idle_gaps": tr.idle_gaps(10)}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    return line


def main(args, t0) -> int:
    registry = Registry()
    cell = registry.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0, registry)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    name = torch.cuda.get_device_name(0)
    line = result_line(cell, out, name, chips)
    rec = out["stretch"]
    print(f"portbench: {args.workload} seed {args.seed} trace {args.trace} on "
          f"{_power_limit()}; {out['attempted']} {'requests' if 'requests' in rec else 'steps'} "
          f"in the window; kernel launches each {out['launches']}", file=sys.stderr)
    print("portbench: set-up seconds from process start: " + ", ".join(
        f"{name} {t:.3f}" for name, t in out["setup_marks"]), file=sys.stderr)
    if "latency_ms" in rec:
        lat = rec["latency_ms"]
        print(f"portbench: request ms median {stats.percentile(lat, 50)!r}, p95 "
              f"{stats.percentile(lat, 95)!r} of {len(lat)}", file=sys.stderr)
    for cname, v, lim in out["checks"]:
        print(f"check {cname}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"
