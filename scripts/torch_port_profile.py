#!/usr/bin/env python3
"""Where the PyTorch port's serving, training or eval time goes on one NVIDIA GPU.

    python3 scripts/torch_port_profile.py [--batch 8] [--requests 3]
    python3 scripts/torch_port_profile.py --train [--reg Mixed] [--learn_mask] [--batch 4] [--requests 3]
    python3 scripts/torch_port_profile.py --train --reg Mixed --use_amp [--after_smoke]
    python3 scripts/torch_port_profile.py --taylor [--batch 4] [--requests 3]
    python3 scripts/torch_port_profile.py --eval [--batch 16] [--requests 3]

Builds the CSModel at the default widths (320 x 320, 1 coil, 4x
equispaced) with the synthetic weights and phantoms of chip_smoke.py,
warms it up, then profiles `--requests` reconstruct calls (or, with
--train, train steps of regime --reg: set_input + update; Rec by default,
or Mixed with the reference's recipe and, as chip_smoke.py's Mixed phase,
PBSpline augmentation of 352 planes cropped to 320, on the card, inside
the profiled step; with --learn_mask, Rec learning a LOUPE mask at
sparsity 0.25, as chip_smoke.py's phase 13; or, with --taylor,
`taylor_step`s of a Taylor mask; or, with --eval, volumes of --batch slices through the
eval CLI's loop, `engine/eval.py::evaluate`, with net_G's weights from
chip_smoke.py too) with torch.profiler and
prints: slices/s, the device time by the category of the aten op that
launched it, the top ops and kernels, and the device's idle share of the
profiled window (one minus the union of kernel intervals over the
window). --use_amp computes the nets in bf16 (the cfg's bf16 policy, as
chip_smoke.py's phase 14). --after_smoke first runs chip_smoke.py's whole
script (`chip_smoke.main`) in the same process, so that the profiled
steps meet the state its phases leave (the caching allocator, threads,
the Python heap), and prints the threads alive before profiling. Needs a
card.
"""

import argparse
import collections
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OP_CATEGORIES = (  # first match wins, on the lower-cased aten op name
    ("conv", ("conv",)),
    ("fft", ("fft",)),
    ("optimizer", ("_foreach", "adam")),
    ("norm/reduce", ("var_mean", "batch_norm", "sum", "mean", "norm")),
    ("copy", ("copy", "to", "fill", "zero", "cat", "pad", "roll")),
)


def op_category(name):
    low = name.lower()
    for cat, keys in OP_CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise/other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--batch", type=int, default=None,
                    help="slices per request or step (8 serving, 4 training)")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of serving")
    ap.add_argument("--reg", default="Rec", choices=("Rec", "Mixed"),
                    help="the train steps' regime (with --train)")
    ap.add_argument("--learn_mask", action="store_true",
                    help="with --train --reg Rec: learn a LOUPE mask")
    ap.add_argument("--eval", action="store_true",
                    help="profile eval volumes (CSModel.test) instead of serving")
    ap.add_argument("--taylor", action="store_true",
                    help="profile Taylor saliency steps (CSModel.taylor_step)")
    ap.add_argument("--use_amp", action="store_true",
                    help="compute the nets in bf16 (cfg.use_amp)")
    ap.add_argument("--after_smoke", action="store_true",
                    help="run chip_smoke.py's whole script in this process first")
    args = ap.parse_args()
    if args.train + args.eval + args.taylor > 1:
        raise SystemExit("--train, --eval and --taylor exclude each other")
    if args.learn_mask and not (args.train and args.reg == "Rec"):
        raise SystemExit("--learn_mask needs --train --reg Rec")
    if args.batch is None:
        args.batch = 4 if args.train or args.taylor else 16 if args.eval else 8

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.eval import evaluate

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card available")
    if args.after_smoke:
        t0 = time.perf_counter()
        if chip_smoke.main() != 0:
            raise SystemExit("chip_smoke.py failed")
        chip_smoke.free_card()
        print(f"chip_smoke.py ran in {time.perf_counter() - t0:.1f} s; threads alive: "
              f"{[t.name for t in threading.enumerate()]}", flush=True)
    print(f"card: {chip_smoke.nvidia_smi()}", flush=True)
    rng = np.random.default_rng(0)
    gan = args.train and args.reg == "Mixed"
    if gan:
        cfg = chip_smoke.mixed_cfg()
    elif args.learn_mask:
        cfg = chip_smoke.mask_cfg()
    elif args.taylor:
        cfg = chip_smoke.mask_cfg(reg="None", mask="taylor", learn_mask=False)
    else:
        cfg = chip_smoke.train_cfg() if args.train else chip_smoke.serving_cfg()
    cfg.use_amp = args.use_amp
    model = CSModel(cfg=cfg, device="cuda", seed=0)
    model.load_entries(chip_smoke.random_entries(model, rng, gan=args.eval))
    side = chip_smoke.AUG_SHAPE if gan else cfg.shape
    reqs = [chip_smoke.phantoms(rng, args.batch, side) for _ in range(args.requests)]
    gen = torch.Generator(device=model.device).manual_seed(0)
    if args.eval:
        model.eval()

    def run(full, aux):
        if args.eval:
            evaluate(model, [list(zip(full, aux))], chip_smoke.EVAL_BUCKET)
        elif args.train:
            if gan:
                full, aux = chip_smoke.augmented_batch(full, aux, gen, model.device,
                                                       cfg.shape)
            model.set_input(full, aux)
            model.update()
        elif args.taylor:
            model.set_input(full, aux)
            model.taylor_step()
        else:
            model.reconstruct(full, aux)

    for full, aux in reqs[:2]:
        run(full, aux)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for full, aux in reqs:
            run(full, aux)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows, without the ranges of annotations such as Optimizer.step
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e.time_range.end for e in prof.events()) - min(
        e.time_range.start for e in prof.events())

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    total = sum(us for us, _ in by_name.values())
    # device time by the aten op that launched it; kernels launched outside
    # any aten op (the port's ctypes kernels) stay unattributed
    by_cat = collections.Counter()
    for avg in prof.key_averages():
        if avg.key.startswith("aten::"):  # kernel rows would count twice
            by_cat[op_category(avg.key[len("aten::"):])] += avg.self_device_time_total
    by_cat["(no aten op: ctypes kernels)"] = total - sum(by_cat.values())
    n_slices = args.batch * args.requests
    what = (f"{args.reg} train steps" + (" (LOUPE learned)" if args.learn_mask else "")
            + (" in bf16" if args.use_amp else "")
            if args.train else "eval volumes" if args.eval
            else "Taylor steps" if args.taylor else "requests")
    print(f"{args.requests} {what} x {args.batch} slices in {wall * 1e3:.1f} ms "
          f"host wall under the profiler: {n_slices / wall:.2f} slices/s")
    print(f"device kernel time {total / 1e3:.2f} ms "
          f"({total / 1e3 / n_slices:.3f} ms/slice); device busy "
          f"{busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms window: idle share "
          f"{1 - busy / window:.3f}")
    print("device time by launching op category:")
    for cat, us in by_cat.most_common():
        print(f"  {cat:30s} {us / 1e3:9.3f} ms  {us / total:6.1%}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20,
                                    max_name_column_width=60))
    print("top kernels (device ms, launches):")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:9.3f} {cnt:6d}  {name[:110]}")


if __name__ == "__main__":
    main()
