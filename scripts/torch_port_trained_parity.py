#!/usr/bin/env python3
"""The port's eval against the JAX eval on a checkpoint trained at full
width, in two halves: `card` trains and scores on an NVIDIA GPU, `host`
scores what comes back with both eval CLIs on the CPU.

    python3 scripts/torch_port_trained_parity.py card [--seed 0] [--out DIR]
    JAX_PLATFORMS=cpu python3 scripts/torch_port_trained_parity.py host [--out DIR]

card (needs a card unless `--device cpu`; imports nothing of JAX):
  1. phantom volumes from `--seed` (chip_smoke.py's `phantoms`, drawn as
     its `cli_volumes` draws them): `--train_volumes` at 1.1x `--shape`,
     then `--val_volumes` at `--shape`, `--slices` slices each;
  2. the reference's four stages (chip_smoke.py's CLI_STAGES,
     commands_train_test.sh:48-65) through the train CLI's `main` on
     those slices in memory, each stage warm-started from its source's
     best.pt through `--resume ... --load_nets ...`: `--shape`, f32,
     equispaced at sparsity 0.25, batch `--batch`, the reference's
     weights, PBSpline augmentation, at least `--iters` iterations a stage
     (whole epochs), every epoch validated and best.pt kept;
  3. link 1: the Proposed stage's best.pt through `engine/eval.py::
     evaluate` on the device and on the CPU in f32, held to chip_smoke.py's
     eval bars (PSNR within 1e-3 dB, MI 1e-4, the rest rtol 1e-4);
  4. readings on the same checkpoint on the device: min |sens| over the
     val slices (chip_smoke.py's `sens_range`), per-volume PSNR under the
     bf16 policy and at `--matmul_precision high` (TF32) minus f32, and
     the f32 eval's peak device memory;
  5. the package that comes back from the GPU's machine, whose output may
     carry at most 64 MiB: the checkpoint holds 189 MB (net_T and net_R
     alone 83 MB, about 60 MiB even coded without loss), so net_T and
     net_R go back with every f32 rounded to nearest at 15 explicit
     mantissa bits (the low byte zero: a relative change of at most
     2^-16), their top three bytes in compressed planes, with net_mask
     and the config. That rounded checkpoint is scored on the device and
     the CPU too, and its PSNR beside the exact one's;
  6. into `--out`: package.npz, summary.json (the flags, versions, card,
     stages, links, readings, a sha256 of every val volume and of the
     rounded entries) and a metrics file a scoring in the eval CLI's format.
  Exits 1 when link 1 misses a bar, after writing everything.

host (imports JAX only in the JAX eval CLI's subprocess):
  1. the volumes regenerated from the summary's seed, the val volumes'
     sha256 held to the card's (a mismatch stops it);
  2. the checkpoint rebuilt from the package (each entry's sha256 held to
     the card's) with a stand-in net_G and net_D that both CLIs load:
     net_G from chip_smoke.py's `random_entries` (spectral vectors
     converged, so its eval output stays finite), net_D fresh from the
     seed; the reconstruction and its PSNR read neither;
  3. the val volumes as h5 files and a CSV (target T2, reference T1);
  4. both eval CLIs in subprocesses, on the same checkpoint, volumes and
     bucket: the JAX one with `--platform cpu --matmul_precision highest`,
     the port's with `--device cpu`; each one's peak RSS, and a stop when
     it passes `--max_rss_gib`;
  5. link 2: per-volume PSNR differences against the 0.1 dB bar
     (scripts/compare_metrics.py's rule) and against 1e-3 dB, the other
     scalars beside them; the port's PSNR here against the card machine's
     CPU on the rounded checkpoint; both CLIs' `--save` volumes scored with
     the port's `utils/metrics.py`;
  6. host.json into `--out`. Exits 1 when link 2 misses the 0.1 dB bar.
"""

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402 (the repo root on the path first)

WORK = os.path.join(REPO, "build", "trained_parity")
OUT = os.path.join(WORK, "out")
STAGE_ITERS = (300, 300, 300, 600)  # at least, for each of chip_smoke.CLI_STAGES
ROUNDED_NETS = ("net_T", "net_R")  # what the package carries, rounded
PARITY_DB = 0.1  # the port's bar against the JAX eval (BASELINE.md:17)
TOY_DB = 1e-3  # what the toy checkpoints of tests/test_torch_port_eval.py meet
SCORINGS = ("card_f32", "cpu_f32", "card_bf16", "card_tf32", "card_rounded", "cpu_rounded")


# ------------------------------------------------------------------ shared
def volumes(seed, shape, train_volumes, val_volumes, slices):
    """(train, val): lists of (full, aux) phantom volumes, complex64 [S, 1,
    H, W], train at int(1.1 shape), val at `shape`, drawn in that order
    from one generator of `seed`, as chip_smoke.py's `cli_volumes`."""
    rng = np.random.default_rng(seed)
    aug = shape * 11 // 10
    train = [chip_smoke.phantoms(rng, slices, aug) for _ in range(train_volumes)]
    val = [chip_smoke.phantoms(rng, slices, shape) for _ in range(val_volumes)]
    return train, val


def volume_sha(full, aux):
    """sha256 of a volume's target and reference bytes."""
    return hashlib.sha256(np.ascontiguousarray(full).tobytes()
                          + np.ascontiguousarray(aux).tobytes()).hexdigest()


def as_slices(vol):
    """A volume as the eval loop reads it: slices [target, aux]."""
    full, aux = vol
    return [[full[i], aux[i]] for i in range(full.shape[0])]


def entries_sha(entries):
    """sha256 over a checkpoint's net entries (names, shapes, dtypes,
    bytes) in sorted order."""
    h = hashlib.sha256()
    for net in sorted(entries):
        for key in sorted(entries[net]):
            a = np.ascontiguousarray(entries[net][key])
            h.update(f"{net}:{key}:{a.shape}:{a.dtype}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def round24(a):
    """f32 `a` rounded to nearest (ties to even) at 15 explicit mantissa
    bits: the low byte of each value zero."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7F) + ((u >> np.uint32(8)) & np.uint32(1))) & np.uint32(0xFFFFFF00)
    out = r.view(np.float32)
    if not np.isfinite(out).all():
        raise ValueError("round24 of a non-finite value")
    return out


def pack(entries, path):
    """Write the rounded nets' entries to `path` (npz, compressed): each
    f32 entry as its top three bytes, one plane each; others as they are.
    Returns {net: {key: [shape, dtype]}}."""
    arrays, layout = {}, {}
    for net, flat in entries.items():
        layout[net] = {}
        for key, a in flat.items():
            a = np.ascontiguousarray(a)
            layout[net][key] = [list(a.shape), str(a.dtype)]
            if a.dtype == np.float32:
                u = a.reshape(-1).view(np.uint32)
                if (u & np.uint32(0xFF)).any():
                    raise ValueError(f"{net} {key}: not rounded")
                a = np.stack([(u >> np.uint32(s)).astype(np.uint8) for s in (8, 16, 24)])
            arrays[f"{net}:{key}"] = a
    np.savez_compressed(path, **arrays)
    return layout


def unpack(path, layout):
    """The entries `pack` wrote to `path`."""
    out = {}
    with np.load(path) as z:
        for net, keys in layout.items():
            out[net] = {}
            for key, (shape, dtype) in keys.items():
                a = z[f"{net}:{key}"]
                if dtype == "float32":
                    u = sum(a[i].astype(np.uint32) << np.uint32(s)
                            for i, s in enumerate((8, 16, 24)))
                    a = u.view(np.float32)
                out[net][key] = a.reshape(shape).astype(dtype, copy=False)
    return out


def metrics_file(path, stats, **meta):
    """Per-volume scalars in the eval CLI's metrics format."""
    with open(path, "w") as f:
        json.dump({"meta": meta, "volumes": stats}, f)


def read_metrics(path):
    with open(path) as f:
        return json.load(f)["volumes"]


def psnr_diffs(got, want):
    """Per-volume metric_PSNR got - want."""
    return [g["metric_PSNR"] - w["metric_PSNR"] for g, w in zip(got, want)]


def eval_misses(got, want):
    """Where `got` misses chip_smoke.py's eval bars against `want`, per
    volume: [(volume, key, got, want, bar)]."""
    misses = []
    for i, (g, w) in enumerate(zip(got, want)):
        for k, v in w.items():
            bar = (chip_smoke.EVAL_PSNR_ATOL if k == "metric_PSNR"
                   else chip_smoke.EVAL_MI_ATOL if k == "metric_MI"
                   else chip_smoke.EVAL_RTOL * abs(v))
            if not abs(g[k] - v) <= bar:
                misses.append((i, k, g[k], v, bar))
    return misses


def set_flag(argv, flag, value):
    argv[argv.index(flag) + 1] = str(value)
    return argv


# -------------------------------------------------------------------- card
def train_stages(args, train, val, root, device):
    """The four stages through the train CLI's `main`; returns each one's
    record (iterations, seconds, val PSNR a epoch, launches)."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine import train as train_cli

    records = []
    for (name, reg, ref, source, nets), iters in zip(chip_smoke.CLI_STAGES, args.iters):
        single = ref == "None"
        train_set = chip_smoke.cli_slices(train, single)
        val_set = chip_smoke.cli_slices(val, single)
        epochs = math.ceil(iters / (len(train_set) // args.batch))
        argv = chip_smoke.cli_argv(os.path.join(root, name), reg, ref, args.shape, args.batch,
                                   args.net_scale, device)
        set_flag(set_flag(argv, "--epoch", epochs), "--seed", args.seed)
        if source:
            argv += ["--resume", os.path.join(root, source, "ckpt", "best.pt"),
                     "--load_nets", *nets]
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec = train_cli.main(train_cli.build_parser().parse_args(argv),
                             datasets=(train_set, val_set))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps = sum(e["steps"] for e in rec["epochs"])
        record = {
            "stage": name, "reg": reg, "ref": ref, "warm_start": source, "load_nets": nets,
            "epochs": epochs, "iterations": rec["iter_cnt"], "seconds": seconds,
            "ms_a_step": 1e3 * sum(e["seconds"] for e in rec["epochs"]) / steps,
            "val_psnr": [e["val"]["metric_PSNR"] for e in rec["epochs"]],
            "launches": dict(kernels.LAUNCHES),
        }
        chip_smoke.log(f"stage {name}: {record}")
        if rec["iter_cnt"] < iters:
            raise AssertionError(f"stage {name}: {rec['iter_cnt']} iterations, {iters} asked")
        records.append(record)
    return records


def score(model, vols):
    """`evaluate` of `vols` at chip_smoke.py's eval bucket; (scalars,
    seconds, peak device MiB or None)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.eval import evaluate

    is_cuda = model.device.type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = evaluate(model, [as_slices(v) for v in vols], chip_smoke.EVAL_BUCKET)
    if is_cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20 if is_cuda else None
    return stats, time.perf_counter() - t0, peak


def open_eval(ckpt, device, cfg=None, entries=None):
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    model = CSModel(cfg=cfg, ckpt=ckpt, device=device)
    if entries is not None:
        model.load_entries(entries)
    model.eval()
    return model


def card(args):
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load
    from spatialalignmentnetwork_tpu_torch.engine.config import Config
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import resolve_device

    device = resolve_device(args.device)
    is_cuda = device.type == "cuda"
    t_start = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    root = os.path.join(args.work, "card")
    shutil.rmtree(root, ignore_errors=True)
    card_name = chip_smoke.nvidia_smi() if is_cuda else "cpu"
    chip_smoke.log(f"device: {card_name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
                   f"numpy {np.__version__}")
    if is_cuda:
        chip_smoke.build_kernels(["grid_sample.cu", "ssim.cu"])
    train, val = volumes(args.seed, args.shape, args.train_volumes, args.val_volumes,
                         args.slices)
    stages = train_stages(args, train, val, root, device)
    best = os.path.join(root, chip_smoke.CLI_STAGES[-1][0], "ckpt", "best.pt")

    # link 1 and the readings, on the exact checkpoint
    scalars, seconds = {}, {}
    model = open_eval(best, device)
    cfg = model.cfg
    scalars["card_f32"], seconds["card_f32"], peak = score(model, val)
    sens = [chip_smoke.sens_range(model, *(torch.from_numpy(a).to(device) for a in v))
            for v in val]
    del model
    chip_smoke.free_card()
    amp = Config(**cfg.to_dict())
    amp.use_amp = True
    model = open_eval(best, device, cfg=amp)
    scalars["card_bf16"], seconds["card_bf16"], _ = score(model, val)
    del model
    chip_smoke.free_card()
    t0 = time.perf_counter()
    scalars["card_tf32"] = [
        chip_smoke.eval_at_precision(as_slices(v), chip_smoke.EVAL_BUCKET, "high", ckpt=best,
                                     device=device)
        for v in val]
    seconds["card_tf32"] = time.perf_counter() - t0
    chip_smoke.free_card()
    scalars["cpu_f32"], seconds["cpu_f32"], _ = score(open_eval(best, "cpu"), val)

    # the rounded checkpoint that goes back
    exact = ckpt_load(best)
    rounded = {net: {k: round24(a) if a.dtype == np.float32 else a
                     for k, a in exact[net].items()} for net in ROUNDED_NETS}
    rounded["net_mask"] = exact["net_mask"]
    model = open_eval(best, device, entries=rounded)
    scalars["card_rounded"], seconds["card_rounded"], _ = score(model, val)
    del model
    chip_smoke.free_card()
    scalars["cpu_rounded"], seconds["cpu_rounded"], _ = score(
        open_eval(best, "cpu", entries=rounded), val)
    package = os.path.join(args.out, "package.npz")
    layout = pack(rounded, package)

    misses = eval_misses(scalars["cpu_f32"], scalars["card_f32"])
    misses_rounded = eval_misses(scalars["cpu_rounded"], scalars["card_rounded"])
    dev = "card" if is_cuda else "cpu"
    for name in SCORINGS:
        metrics_file(os.path.join(args.out, f"metrics_{name}.json"), scalars[name],
                     device=card_name if name.startswith("card") else "cpu",
                     torch=torch.__version__, checkpoint=best,
                     matmul_precision="high" if name == "card_tf32" else None,
                     use_amp=name == "card_bf16", rounded=name.endswith("rounded"))
    summary = {
        "args": vars(args), "device": card_name, "torch": torch.__version__,
        "cuda": torch.version.cuda, "numpy": np.__version__, "config": cfg.to_dict(),
        "val_sha256": [volume_sha(*v) for v in val],
        "stages": stages,
        "link1": {
            "psnr_cpu_minus_device": psnr_diffs(scalars["cpu_f32"], scalars["card_f32"]),
            "misses": misses,
            "rounded_psnr_cpu_minus_device": psnr_diffs(scalars["cpu_rounded"],
                                                        scalars["card_rounded"]),
            "rounded_misses": misses_rounded,
            "bars": {"psnr_db": chip_smoke.EVAL_PSNR_ATOL, "mi": chip_smoke.EVAL_MI_ATOL,
                     "rtol": chip_smoke.EVAL_RTOL},
        },
        "readings": {
            "sens_min_median_max": sens,
            "sens_min": min(s[0] for s in sens),
            "psnr_bf16_minus_f32": psnr_diffs(scalars["card_bf16"], scalars["card_f32"]),
            "psnr_tf32_minus_f32": psnr_diffs(scalars["card_tf32"], scalars["card_f32"]),
            "psnr_rounded_minus_exact": psnr_diffs(scalars["card_rounded"],
                                                   scalars["card_f32"]),
            "peak_device_mib": peak,
            "eval_seconds": seconds,
        },
        "package": {"layout": layout, "entries_sha256": entries_sha(rounded),
                    "bytes": os.path.getsize(package)},
        "seconds": time.perf_counter() - t_start,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    chip_smoke.log(f"link 1 ({dev} vs cpu, exact best.pt): PSNR cpu - {dev} "
                   f"{summary['link1']['psnr_cpu_minus_device']} dB; rounded "
                   f"{summary['link1']['rounded_psnr_cpu_minus_device']} dB; misses "
                   f"{misses + misses_rounded}")
    chip_smoke.log(f"readings on {card_name}: {json.dumps(summary['readings'])}")
    chip_smoke.log(f"package {summary['package']['bytes'] / 2**20:.2f} MiB; "
                   f"{summary['seconds']:.1f} s in all")
    return 1 if misses or misses_rounded else 0


# -------------------------------------------------------------------- host
def assemble(package_dir, summary, path):
    """The checkpoint both CLIs load, written to `path`: the package's
    nets and config, net_G from chip_smoke.py's `random_entries`, net_D
    fresh from the card's seed."""
    from spatialalignmentnetwork_tpu_torch.engine.config import Config
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    seed = summary["args"]["seed"]
    entries = unpack(os.path.join(package_dir, "package.npz"), summary["package"]["layout"])
    if entries_sha(entries) != summary["package"]["entries_sha256"]:
        raise AssertionError("the package does not unpack to the card's entries")
    model = CSModel(cfg=Config(**summary["config"]), device="cpu", seed=seed)
    entries["net_G"] = chip_smoke.random_entries(
        model, np.random.default_rng(seed), gan=True)["net_G"]
    model.load_entries(entries)
    model.save(path)


def write_h5(vols, root):
    """Each (full, aux) volume as two h5 files (target T2, reference T1;
    `max` 1, so that the data layer's slices are the volume's own values)
    and their CSV; returns the CSV's path."""
    import h5py

    os.makedirs(root, exist_ok=True)
    rows = []
    for i, (full, aux) in enumerate(vols):
        for proto, img in (("T2", full), ("T1", aux)):
            with h5py.File(os.path.join(root, f"vol{i}_{proto}.h5"), "w") as h5:
                h5.create_dataset("image", data=img[:, 0])
                h5.attrs["max"] = 1.0
                h5.attrs["acquisition"] = proto
        rows.append(f"vol{i}_T1.h5,vol{i}_T2.h5")
    csv = os.path.join(root, "pairs.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv


def cli_command(who, ckpt, csv, out):
    """The eval CLI of `who` ("jax" or "port") on the CPU, scoring `ckpt`
    on `csv` into out/<who>.json and out/<who>_save, bucket as on the
    card."""
    flags = ["--resume", ckpt, "--val", csv, "--protocals", "T2", "T1", "--bucket",
             str(chip_smoke.EVAL_BUCKET),
             "--metric", os.path.join(out, f"{who}.json"), "--save",
             os.path.join(out, f"{who}_save")]
    if who == "jax":
        return [sys.executable, "-m", "spatialalignmentnetwork_tpu.engine.eval", *flags,
                "--platform", "cpu", "--matmul_precision", "highest"]
    return [sys.executable, "-m", "spatialalignmentnetwork_tpu_torch.engine.eval", *flags,
            "--device", "cpu"]


def rss_kib(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def run_cli(who, ckpt, csv, out, max_rss_gib, threads=None):
    """Run `cli_command` with its log in out/<who>.log, stopped when its
    resident memory passes `max_rss_gib`; returns (metrics, seconds, peak
    RSS in GiB)."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    # the JAX CLI keeps its compile cache under $HOME: the work directory's
    env["HOME"] = os.path.join(out, "home")
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    log = os.path.join(out, f"{who}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cli_command(who, ckpt, csv, out), cwd=REPO, env=env,
                                stdout=f, stderr=subprocess.STDOUT)
        peak = 0
        while True:
            pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                proc.returncode = os.waitstatus_to_exitcode(status)
                peak = max(peak, usage.ru_maxrss)
                break
            peak = max(peak, rss_kib(proc.pid))
            if peak > max_rss_gib * 2**20:
                proc.kill()
                proc.wait()
                raise RuntimeError(f"the {who} eval CLI passed {max_rss_gib} GiB; see {log}")
            time.sleep(0.5)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"the {who} eval CLI exited {proc.returncode}:\n{tail}")
    return read_metrics(os.path.join(out, f"{who}.json")), seconds, peak / 2**20


def compare(port, jax):
    """Per volume: port - JAX for every scalar, and whether PSNR is within
    PARITY_DB and within TOY_DB."""
    rows = []
    for p, j in zip(port, jax):
        diff = {k: p[k] - v for k, v in j.items()}
        rows.append({"diff": diff, "parity": abs(diff["metric_PSNR"]) <= PARITY_DB,
                     "toy": abs(diff["metric_PSNR"]) <= TOY_DB})
    return rows


def saved_scores(save, n):
    """The port's `utils/metrics.py` on a CLI's --save volumes: per volume,
    the reconstruction against the fully sampled image."""
    from spatialalignmentnetwork_tpu_torch.utils import metrics

    out = []
    for i in range(n):
        gt, rec = (np.load(os.path.join(save, f"{i}_{name}.nii.npy"))[:, None]
                   for name in ("image", "rec"))
        out.append({"psnr": metrics.psnr(gt, rec), "ssim": metrics.ssim(gt, rec),
                    "mse": metrics.mse(gt, rec), "mae": metrics.mae(gt, rec)})
    return out


def host(args):
    with open(os.path.join(args.out, "summary.json")) as f:
        summary = json.load(f)
    card_args = summary["args"]
    root = os.path.join(args.work, "host")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _, val = volumes(card_args["seed"], card_args["shape"], card_args["train_volumes"],
                     card_args["val_volumes"], card_args["slices"])
    shas = [volume_sha(*v) for v in val]
    if shas != summary["val_sha256"]:
        raise AssertionError(f"the val volumes made here are not the card's: {shas} vs "
                             f"{summary['val_sha256']}")
    n = len(val)
    ckpt = os.path.join(root, "ckpt")
    assemble(args.out, summary, ckpt)
    csv = write_h5(val, os.path.join(root, "data"))
    report = {"volumes": n, "val_sha256_match": True, "checkpoint": ckpt, "clis": {}}
    metrics = {}
    for who in ("jax", "port"):
        metrics[who], seconds, peak = run_cli(who, ckpt, csv, root, args.max_rss_gib,
                                              args.threads)
        report["clis"][who] = {"seconds": seconds, "peak_rss_gib": peak,
                               "volumes": metrics[who],
                               "saved": saved_scores(os.path.join(root, f"{who}_save"), n)}
        print(f"{who} eval CLI: {seconds:.1f} s, peak RSS {peak:.2f} GiB, {metrics[who]}",
              flush=True)
    rows = compare(metrics["port"], metrics["jax"])
    card_cpu = read_metrics(os.path.join(args.out, "metrics_cpu_rounded.json"))
    report["link2"] = rows
    report["port_here_minus_card_machine_cpu_psnr"] = psnr_diffs(metrics["port"], card_cpu)
    report["saved_psnr_port_minus_jax"] = [
        p["psnr"] - j["psnr"] for p, j in zip(report["clis"]["port"]["saved"],
                                              report["clis"]["jax"]["saved"])]
    report["parity"] = all(r["parity"] for r in rows)
    report["toy"] = all(r["toy"] for r in rows)
    with open(os.path.join(args.out, "host.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("link 2 (port - JAX, both on the CPU), metric_PSNR a volume: "
          f"{[r['diff']['metric_PSNR'] for r in rows]} dB; within {PARITY_DB} dB: "
          f"{report['parity']}; within {TOY_DB} dB: {report['toy']}")
    print(f"port here - the card machine's CPU (rounded checkpoint), metric_PSNR: "
          f"{report['port_here_minus_card_machine_cpu_psnr']} dB")
    print(f"--save volumes by utils/metrics.py, psnr port - JAX: "
          f"{report['saved_psnr_port_minus_jax']} dB")
    return 0 if report["parity"] else 1


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="half", required=True)
    c = sub.add_parser("card", help="train and score on the device (no JAX)")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--shape", type=int, default=chip_smoke.SHAPE)
    c.add_argument("--net_scale", default="full", choices=["full", "tiny"])
    c.add_argument("--train_volumes", type=int, default=8)
    c.add_argument("--val_volumes", type=int, default=2)
    c.add_argument("--slices", type=int, default=16)
    c.add_argument("--batch", type=int, default=chip_smoke.TRAIN_BATCH)
    c.add_argument("--iters", type=int, nargs=4, default=list(STAGE_ITERS),
                   help="at least this many iterations in each stage (whole epochs)")
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for p in (c, sub.add_parser("host", help="score the returned checkpoint with both "
                                             "eval CLIs on the CPU")):
        p.add_argument("--out", default=OUT,
                       help="the card half's output directory (the host half's input)")
        p.add_argument("--work", default=WORK, help="checkpoints, volumes and logs")
    h = sub.choices["host"]
    h.add_argument("--max_rss_gib", type=float, default=24.0,
                   help="stop an eval CLI whose resident memory passes this")
    h.add_argument("--threads", type=int, default=None,
                   help="OMP_NUM_THREADS for the eval CLIs")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return card(args) if args.half == "card" else host(args)


if __name__ == "__main__":
    sys.exit(main())
