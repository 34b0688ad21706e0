"""The serving loop, `serve_closed`: one client in a closed loop.

Each request is `batch` slices, a pair of complex target and reference
phantoms from a pool made from the seed in set-up and held on the host as
numpy arrays, as a scanner's side holds them. The client passes them to
`CSModel.reconstruct`, reads the reconstruction back to the host, and
only then sends the next request. Traffic keys: `batch`, `pool` (distinct
requests, sent in turn), `warmup` (requests in set-up), `keep_every`
(the window's first request and about one in this many after it, drawn
from the seed, are kept for the check), `max_kept` and `profiled` (requests in the traced sub-window).
"""

import time

import numpy as np
import torch

from harness import check, flops, phantoms, program, weights
from harness.loopkit import Loop, NetTimer, model_widths, span
from reference.model import Reference


class ServeClosed(Loop):
    kind = "serve"
    UNITS = {"slices_per_s": "slices/s", "request_ms_p95": "ms", "setup_s": "s"}
    # the warp of the aligned reference image: one plane a slice
    KERNEL_SHAPES = {"reconstruct": {"grid_sample_fwd": (1, "shape")}}

    def flops_per_slice(self) -> float:
        """net_T's and net_R's forward a slice (the frozen `flops.py`)."""
        c = self.run.model_cfg
        net_r, stn = model_widths(c)
        return (flops.varnet_flops(c["shape"], c["coils"], use_ref=True, **net_r)
                + flops.stn_flops(c["shape"], c["coils"], **stn))

    def setup(self, plant=None):
        run = self.run
        self.marks = [("start", time.perf_counter())]
        state = weights.draw(run.model_cfg, run.sub_seed("weights"), run.device)
        self.state = {n: {k: v.cpu() for k, v in sd.items()} for n, sd in state.items()}
        self.model = program.build_model(run.model_cfg, state, run.mask_seed, run.device)
        del state
        self.marks.append(("model", time.perf_counter()))
        if plant is not None:
            plant(self.model)
        gen = torch.Generator(device=run.device).manual_seed(run.sub_seed("pool"))
        full, aux = phantoms.phantoms(gen, run.traffic["pool"] * self.batch, self.size, run.device)
        full, aux = full.cpu().numpy(), aux.cpu().numpy()
        b = self.batch
        self.pool = [(full[i * b:(i + 1) * b], aux[i * b:(i + 1) * b])
                     for i in range(run.traffic["pool"])]
        self.keep_rng = np.random.default_rng(run.sub_seed("keep"))
        self.kept = []
        self.sent = 0
        self.marks.append(("pool", time.perf_counter()))
        for _ in range(run.traffic["warmup"]):
            self._request(keep=False)
        self.marks.append(("warmup", time.perf_counter()))

    def _request(self, keep=True, spans=False):
        """One request: (issue, return of the call, readback) host times."""
        j = self.sent % len(self.pool)
        self.sent += 1
        t_issue = time.perf_counter()
        with span("portbench.reconstruct", spans), self.launched.phase("reconstruct", spans):
            out = self.model.reconstruct(*self.pool[j])
        t_ret = time.perf_counter()
        with span("portbench.readback", spans):
            host = out.cpu().numpy()
        t_done = time.perf_counter()
        t = self.run.traffic
        # the window's first request, then about one in keep_every
        if keep and len(self.kept) < t["max_kept"] and (
                self.keep_rng.random() < 1.0 / t["keep_every"] or not self.kept):
            self.kept.append((j, host))
        return t_issue, t_ret, t_done

    def window(self, seconds, timed=False) -> dict:
        """Requests for `seconds`; with `timed`, CUDA events on net_T and
        net_R too. The record of the stretch."""
        timer = NetTimer({"net_T": self.model.net_T, "net_R": self.model.net_R}) if timed else None
        reqs = []
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            reqs.append(self._request())
        end = time.perf_counter()
        done = [r for r in reqs if r[2] <= deadline]
        rec = {
            "seconds": seconds, "requests": len(reqs), "span_s": end - start,
            "slices_per_s": len(done) * self.batch / seconds,
            "latency_ms": [(r[2] - r[0]) * 1e3 for r in reqs],
            "dispatch_ms": [(r[1] - r[0]) * 1e3 for r in reqs],
        }
        if timer is not None:
            rec["net_ms"] = {k: v / max(len(reqs), 1) for k, v in timer.close().items()}
        return rec

    def end_to_end(self, rec) -> dict:
        from harness.stats import percentile

        return {"slices_per_s": rec["slices_per_s"],
                "request_ms_p95": percentile(rec["latency_ms"], 95)}

    def profiled(self):
        for _ in range(self.run.traffic["profiled"]):
            self._request(keep=False, spans=True)

    def units(self) -> int:
        """Requests in the profiled sub-window."""
        return self.run.traffic["profiled"]

    def outputs(self):
        """The program's kept answers [(pool index, reconstruction)]."""
        return self.kept

    def reference_outputs(self, rounding=None):
        """The reference's answers to the kept requests' inputs, in f32 or
        in the precision `rounding` names (`reference/precision.py`)."""
        ref = Reference(self.run.model_cfg, self.state, self.run.mask_seed, self.run.device,
                        rounding)
        out, cache = [], {}
        for j, _ in self.kept:
            if j not in cache:
                full, aux = (torch.as_tensor(x, device=self.run.device) for x in self.pool[j])
                cache[j] = ref.serve(full, aux).cpu().numpy()
            out.append((j, cache[j]))
        return out

    def check(self, got=None, want=None, yard=None) -> dict:
        """The numbers compared: the program's kept answers (or `got`, the
        control's) against the f32 reference's (`want`, where known), and
        with the cell's `yardstick` against the reference's own distance
        in that precision (`yard`, where known)."""
        want = dict(want or self.reference_outputs())
        stick = self.run.cell["workload"].get("yardstick")
        if stick and yard is None:
            yard = self.reference_outputs(stick)
        return check.serve_numbers(self.kept if got is None else got, want, yard)


LOOP = ServeClosed
