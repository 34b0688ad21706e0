"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... \
        [--control <n> ...] [--fault <name> <n> ...] [--seconds <s>]

For each seed of --seeds, the program's numbers against the reference
(sound runs: the lower reading is their largest); for each seed of
--control, the control's, the reference in the precision below the
configuration's (`reference/precision.py`), against the f32 reference on
the same inputs; for each --fault, the program with that fault planted
(`harness/faults.py`). Serving runs a short window of --seconds at the
cell's load first and keeps each of its answers, up to as many as a run
compares (`max_kept`), so that the answers compared are a window's. One
JSON line a reading, then a summary line.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def reading(registry, cell_name, seed, seconds, control=None, fault=None, device="cuda"):
    import torch

    from harness import faults
    from harness.cell import Run
    cell = registry.cell(cell_name)
    # keep every request of the short window, up to as many as a run keeps
    cell["traffic"] = dict(cell["traffic"], keep_every=1)
    run = Run(cell, seed, device)
    loop = registry.loop(run.traffic["loop"])(run)
    plant = faults.FAULTS[loop.kind][fault] if fault else None
    loop.setup(plant)
    if loop.kind == "serve":
        loop.window(seconds)
    loop.free()
    if loop.kind == "serve":
        want = loop.reference_outputs()
        stick = cell["workload"].get("yardstick")
        yard = loop.reference_outputs(stick) if stick else None
        outs = {"program": loop.outputs()}
        if control:
            outs["control"] = loop.reference_outputs(cell["config"]["control"])
        rows = {k: {**loop.check(got=got, want=want, yard=yard), "detail": serve_detail(got, want)}
                for k, got in outs.items()}
    else:
        want = loop.reference_record()
        outs = {"program": loop.outputs()}
        if control:
            outs["control"] = loop.reference_record(cell["config"]["control"])
        rows = {k: {**loop.check(got=got, want=want),
                    "detail": train_detail(got, want, loop.state)}
                for k, got in outs.items()}
    del loop
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows


def serve_detail(got, want) -> dict:
    """Quartiles and extremes of the kept slices' relative L2 distances."""
    import statistics

    from harness import check

    errs = sorted(check.slice_rel_l2(got, dict(want)))
    return {"slices": len(errs), "min": errs[0], "quartiles": statistics.quantiles(errs, n=4),
            "max": errs[-1]}


def train_detail(got, want, before) -> dict:
    """Each step's loss gap and the five worst leaves of each number."""
    from harness import check

    out = {"loss_rel_steps": [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]}
    leaves = check.train_leaves(got, want, before)
    for name, (g, w) in zip(("grad", "change", "stats"), leaves):
        gaps = check.leaf_gaps(g, w)
        out[name] = sorted(([".".join(k), v] for k, v in gaps.items()), key=lambda x: -x[1])[:5]
    out["worst_change_leaves"] = [leaf_look(k, got, want, before, leaves[1])
                                  for k in (tuple(x[0].split(".", 1)) for x in out["change"][:3])]
    return out


def leaf_look(key, got, want, before, changes) -> dict:
    """Why a leaf's change departs: its first-step gradient's norm over the
    median leaf's, the share of its elements whose first-step gradient
    lies under the two sides' gap (so that rounding can flip its sign,
    and Adam's first step, lr times the sign, with it), the share whose
    first-step gradient, and whose change, differ in sign."""
    import numpy as np
    import torch

    net, k = key
    g_ref, g_got = want["grads"][net][k].double(), got["grads"][net][k].double()
    med = float(np.median([float(torch.linalg.vector_norm(v.double()))
                           for gs in want["grads"].values() for v in gs.values()]))
    d_got, d_want = (c[key] for c in changes)
    return {"leaf": ".".join(key), "elements": g_ref.numel(),
            "grad_over_median": float(torch.linalg.vector_norm(g_ref)) / med,
            "grad_under_gap": float(((g_ref.abs() < (g_got - g_ref).abs())).double().mean()),
            "grad_sign_differs": float((torch.sign(g_ref) != torch.sign(g_got)).double().mean()),
            "change_sign_differs": float((torch.sign(d_want) != torch.sign(d_got)).double().mean()),
            "change_rel_l2": float(torch.linalg.vector_norm(d_got - d_want)
                                   / torch.linalg.vector_norm(d_want))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--fault", nargs="+", action="append", default=[],
                   metavar=("NAME", "SEED"))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    from harness.registry import Registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    registry = Registry()
    summary = {}
    jobs = ([(s, s in args.control, None) for s in args.seeds]
            + [(s, True, None) for s in args.control if s not in args.seeds]
            + [(int(s), False, f[0]) for f in args.fault for s in f[1:]])
    for seed, control, fault in jobs:
        rows = reading(registry, args.workload, seed, args.seconds, control, fault)
        for kind, numbers in rows.items():
            if fault:
                kind = f"fault:{fault}"
            if kind == "program" and seed not in args.seeds and not fault:
                continue
            print(json.dumps({"seed": seed, "reading": kind, **numbers}), flush=True)
            for k, v in numbers.items():
                if k == "detail":
                    continue
                summary.setdefault(kind, {}).setdefault(k, []).append(v)
    out = {kind: {k: {"max" if kind == "program" else "min": (max if kind == "program" else min)(v),
                      "n": len(v)} for k, v in nums.items()}
           for kind, nums in summary.items()}
    print(json.dumps({"summary": out, "workload": args.workload,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
