"""The training loop, `train_step`: steps of the configuration's regime
(Mixed) dispatched ahead, each on a batch of its own.

Each step takes `batch` pairs of complex target and reference phantoms at
`aug` pixels from a pool made on the device from the seed (`pool_batches`
batches, taken in turn), draws one PBSpline deformation from the seed
(`program.draw_pbspline`), and runs the program's input pipeline and step:
`augment_batch` and `center_crop` to the configuration's shape, then
`set_input` and `update`. Nothing is read back between steps.

Set-up builds the one model the window runs, and drives it through its
first `checked` steps (rows that all differ), recording what the check
compares: each step's loss, the first step's gradients as Adam's state
holds them, and every parameter and statistic after the last checked
step. `warmup` more steps follow. Traffic keys: `batch`, `aug`,
`pool_batches`, `checked`, `warmup`, `profiled` (steps in the traced
sub-window).
"""

import contextlib
import math
import time

import torch

from harness import check, flops, phantoms, program, weights
from harness.loopkit import Events, Loop, model_widths, span
from reference.model import Reference
from reference.ops import center_crop, pbspline

BETA1 = 0.9  # Adam's first moment: after one step exp_avg = (1 - BETA1) * grad


class TrainStep(Loop):
    kind = "train"
    UNITS = {"train_slices_per_s": "slices/s", "setup_s": "s"}
    # augmentation warps each complex image of the pair at `aug` (real and
    # imaginary: two planes); the step's kernels work on one plane a
    # sample at the configuration's shape
    KERNEL_SHAPES = {
        "augment": {"grid_sample_fwd": (2, "aug")},
        "update": {op: (1, "shape") for op in (
            "grid_sample_fwd", "grid_sample_bwd_dgrid", "grid_sample_bwd_dimg", "ssim_fwd",
            "ssim_bwd")},
    }

    def __init__(self, run):
        super().__init__(run)
        t = run.traffic
        self.aug = t["aug"]
        if t["pool_batches"] < t["checked"]:
            raise ValueError("the checked steps need rows that all differ")
        if run.model_cfg["reg"] not in Reference.REGIMES:
            raise ValueError(f"the reference has no {run.model_cfg['reg']!r} step; it has "
                             f"{Reference.REGIMES}")

    def sizes(self) -> dict:
        return {"shape": self.size, "aug": self.aug}

    def flops_per_slice(self) -> float:
        """The regime's step a slice with no recomputation counted (the
        frozen `flops.py`)."""
        c = self.run.model_cfg
        net_r, stn = model_widths(c)
        total, _ = flops.train_step_flops(
            c["reg"], c["shape"], c["coils"], remat=False, remat_tg=False, use_ref=True,
            stn_feat=stn["feat"], stn_layers=stn["layers"], g_layers=tuple(c["net_G_layers"]),
            d_blocks=tuple(tuple(b) for b in c["net_D_blocks"]), **net_r)
        return total

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
        self.pool = phantoms.phantoms(gen, run.traffic["pool_batches"] * self.batch, self.aug,
                                      run.device)
        self.aug_gen = torch.Generator(device=run.device).manual_seed(run.sub_seed("augment"))
        self.steps = 0
        self.record = {"losses": [], "draws": []}
        self.marks.append(("pool", time.perf_counter()))
        for k in range(run.traffic["checked"]):
            self.record["draws"].append({n: d.clone() for n, d in self._step().items()})
            self.record["losses"].append(
                self.model.get_vis("scalars")["scalars"].get("loss_all", math.nan))
            if k == 0:
                self.record["grads"] = self._adam_grads()
        self.record["after"] = self._snapshot()
        self.marks.append(("checked", time.perf_counter()))
        for _ in range(run.traffic["warmup"]):
            self._step()
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        self.marks.append(("warmup", time.perf_counter()))

    def _rows(self, k):
        b = self.batch
        i = k % self.run.traffic["pool_batches"]
        return self.pool[0][i * b:(i + 1) * b], self.pool[1][i * b:(i + 1) * b]

    def _step(self, spans=False, timer=None):
        full, aux = self._rows(self.steps)
        self.steps += 1
        draws = program.draw_pbspline(self.aug_gen, self.batch, self.run.device)
        with span("portbench.augment", spans), self.launched.phase("augment", spans), (
                timer or contextlib.nullcontext()):
            full, aux = program.augment_and_crop(full, aux, draws, self.size)
        t = time.perf_counter()
        with span("portbench.update", spans), self.launched.phase("update", spans):
            self.model.set_input(full, aux)
            self.model.update()
        self.dispatch_s = time.perf_counter() - t
        return draws

    def _adam_grads(self):
        """The first step's gradients as each net's Adam gets them:
        exp_avg / (1 - BETA1) after one step (zero where it has no state)."""
        out = {}
        for name in ("net_T", "net_G", "net_R", "net_D"):
            opt = self.model.opt[name]
            out[name] = {k: (opt.state[p]["exp_avg"] / (1 - BETA1) if p in opt.state
                             else torch.zeros_like(p)).cpu()
                         for k, p in getattr(self.model, name).named_parameters()}
        return out

    def _snapshot(self):
        return {name: {k: v.detach().cpu().clone() for k, v in
                       getattr(self.model, name).state_dict().items()
                       if not k.endswith("num_batches_tracked")}
                for name in ("net_T", "net_G", "net_R", "net_D")}

    def window(self, seconds, timed=False) -> dict:
        """Steps dispatched for `seconds`, then one synchronize; with
        `timed`, CUDA events around each step's augmentation too."""
        aug = []
        dispatch = []
        start = time.perf_counter()
        deadline = start + seconds
        n = 0
        while time.perf_counter() < deadline:
            timer = Events() if timed else None
            self._step(timer=timer)
            if timed:
                aug.append(timer)
                dispatch.append(self.dispatch_s)
            n += 1
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()
        end = time.perf_counter()
        rec = {"seconds": end - start, "steps": n,
               "train_slices_per_s": n * self.batch / (end - start)}
        if timed:
            rec["augment_ms"] = sum(t.ms() for t in aug) / n
            rec["dispatch_ms"] = [s * 1e3 for s in dispatch]
        return rec

    def end_to_end(self, rec) -> dict:
        return {"train_slices_per_s": rec["train_slices_per_s"]}

    def profiled(self):
        for _ in range(self.run.traffic["profiled"]):
            self._step(spans=True)

    def units(self) -> int:
        """Steps in the profiled sub-window."""
        return self.run.traffic["profiled"]

    def outputs(self):
        return self.record

    def reference_record(self, rounding=None):
        """The reference's record of the same checked steps from the same
        weights, inputs and draws, in f32 or in the precision `rounding`
        names."""
        ref = Reference(self.run.model_cfg, self.state, self.run.mask_seed, self.run.device,
                        rounding, train=True)
        rec = {"losses": []}
        for k, draws in enumerate(self.record["draws"]):
            full, aux = (center_crop(x, self.size) for x in pbspline(list(self._rows(k)), draws))
            loss, grads = ref.train_step(full, aux)
            rec["losses"].append(float(loss))
            if k == 0:
                rec["grads"] = {n: {k2: g.cpu() for k2, g in gs.items()} for n, gs in grads.items()}
        rec["after"] = {name: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()
                               if not k.endswith("num_batches_tracked")}
                        for name, net in ref.nets.items()}
        return rec

    def check(self, got=None, want=None) -> dict:
        """The numbers compared: the program's record (or `got`, the
        control's) against the f32 reference's (`want`, where known)."""
        return check.train_numbers(got or self.record, want or self.reference_record(),
                                   self.state)



LOOP = TrainStep
