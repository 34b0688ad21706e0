"""The train CLI (counterpart of the JAX package's `engine/train.py`, which
mirrors the reference's train.py flag surface).

    python -m spatialalignmentnetwork_tpu_torch.engine.train --logdir LOG \
        --train train.csv --val val.csv --protocals T2 T1 --reg Mixed \
        --mask equispaced --sparsity 0.25 --smooth_weight 1000 \
        --gan_weight 0.1 --gan_sim_weight 1 --sim_weight 1 \
        --aux_aug PBSpline --batch_size 4 --prefetch \
        [--resume CKPT [--load_nets net_mask ...]] \
        [--matmul_precision {default,high,highest}] [--device cuda]

Flow (the reference's train.py:61-315): a Config from the flags; a
`CSModel` built fresh, resumed from the latest checkpoint of the logdir
(`--resume ""`, the iteration count taken from its name), or loaded from
a checkpoint, whole or only the nets `--load_nets` names (the staged
protocol's warm start, commands_train_test.sh:48-65); paired-volume
datasets from CSV manifests (train slices cropped to 1.1x the crop, val
slices to the crop), or native slice caches (`--native_cache`); then
`run`, the epoch loop: each batch is copied to the card, augmented there
(`--aux_aug`, draws from a generator on the card seeded by `--seed`) and
center-cropped, then `set_input` and `update`; with `--prune_every N`, a
Taylor mask's `taylor_step` after every update and `prune(--prune_num)`
every N iterations (a LOUPE mask learns through `--learn_mask` instead);
TensorBoard scalars and histograms every SCALARS_EVERY iterations, image
grids and checkpoints at their cadences; validation through
`CSModel.test` after each epoch, with `best.pt` and early stopping
(`--intel_stop`); a final checkpoint.

`run` takes the model and any two datasets (`__len__`, `__getitem__`), so
that data in memory can be trained on without h5py.

Runs on the card unless `--device cpu` is asked for; with no card and no
`--device cpu` it raises. `--use_amp` trains under the bf16 policy
(`cfg.use_amp`, engine/csmodel.py). `--matmul_precision` takes the JAX
CLI's levels with JAX's meaning on a GPU: "default" and "high" run the
nets' f32 convs and matmuls in TF32, "highest" in true f32, which is also
the policy without the flag (`engine/csmodel.py::set_matmul_precision`);
the level holds for the CLI's run. Flags that cannot act raise
ValueError naming the flag, as the JAX CLI's asserts: `--learn_mask`
without `--mask loupe` or under `--reg GAN-Only`, `--prune_every` without
`--prune_num` or with a LOUPE mask.

Data parallelism (`--data_parallel`, `parallel/mesh.py`): one process a
card, each a rank of a torch.distributed world (nccl on cards, gloo with
`--device cpu`), the model replicated from rank 0 and each step the
global batch's (`CSModel.distribute`). Outside a world, `--data_parallel`
spawns one process for each visible card (the CPU counts as one); under
torchrun (RANK and WORLD_SIZE set) or in a process that joined a group,
the CLI joins that world; `--dist_coordinator HOST:PORT
--dist_num_processes P --dist_process_id i` (one CLI a host, as the JAX
CLI's multi-host flags) spawns this host's cards as ranks i x cards + k
of a world of P x cards meeting at the coordinator. `--batch_size` stays
the global batch: each rank loads its shard (`Loader(batch_size / W,
num_shards=W, shard_index=rank)`) and folds its rank into the
augmentation generator's seed; validation gathers the val batch, so that
every rank scores the global batch and `best.pt` and `--intel_stop`
decide alike. Rank 0 alone writes TensorBoard and checkpoints; image
grids are skipped for W > 1, as the JAX CLI skips them. A world of more
than one process needs `--data_parallel` and `--seed`, and a global
batch that divides over it (ValueError otherwise, as the JAX CLI's
asserts).
"""

import argparse
import glob
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..data import augment
from ..data.loader import Loader, Prefetch, device_prefetch
from ..data.paired_dataset import ConcatDataset, get_paired_volume_datasets
from ..ops.crop import center_crop
from ..parallel import mesh as mesh_lib
from ..utils.trace import span
from ..utils.visualize import save_image
from .config import Config
from .csmodel import MATMUL_PRECISIONS, CSModel, f32_precision, resolve_device

AUG_POLICIES = ("None", "Rigid", "BSpline", "PBSpline")

# cadences in iterations (the reference's train.py:230-258)
SCALARS_EVERY = 50  # TensorBoard scalars and histograms, the progress line
IMAGES_EVERY = 100  # image grids, below LATE_ITERS ...
IMAGES_EVERY_LATE = 1000  # ... and every this many at any count
CKPT_EVERY = 1000  # checkpoints, below LATE_ITERS ...
CKPT_EVERY_LATE = 5000  # ... and every this many at any count
LATE_ITERS = 10000
DATA_STALL_S = 0.1  # a wait for data this long shows on the progress line
LEN_VIS, COL_VIS = 16, 4  # the image grids' val slices and columns
VIS_SEED = 19950102 + 666 + 233


def _due(it, every, every_late):
    return it % every_late == 0 or (it < LATE_ITERS and it % every == 0)


def draw_augmentation(policy, gen, n, count, device):
    """The draws of `augment.augment_batch(policy, ...)` for a batch of `n`
    samples and `count` modalities, from `gen`: none for "None", one
    `augment.draw` for "PBSpline" (one grid for every modality), one a
    modality for "Rigid" and "BSpline"."""
    if policy == "None":
        return None
    if policy == "PBSpline":
        return augment.draw(gen, n, device)
    return [augment.draw(gen, n, device, bspline=policy == "BSpline") for _ in range(count)]


def world_of(args, device) -> int:
    """The number of ranks the flags ask for, after the JAX CLI's checks
    of `--dist_*` as ValueErrors: the joined world's size (torchrun's, or
    a group this process joined), else with `--dist_*` the processes x
    this host's devices, else with `--data_parallel` this host's devices
    (the cards; the CPU counts as one), else 1."""
    dist_flags = (args.dist_coordinator, args.dist_num_processes, args.dist_process_id)
    if any(f is not None for f in dist_flags):
        if not args.data_parallel:
            raise ValueError("--dist_coordinator, --dist_num_processes and "
                             "--dist_process_id need --data_parallel")
        if any(f is None for f in dist_flags):
            raise ValueError("--dist_coordinator, --dist_num_processes and "
                             "--dist_process_id go together")
        if not 0 <= args.dist_process_id < args.dist_num_processes:
            raise ValueError(f"--dist_process_id {args.dist_process_id} outside "
                             f"{args.dist_num_processes} processes")
        if mesh_lib.in_world():
            raise ValueError("--dist_* in a world already joined (torchrun)")
    if mesh_lib.in_world():
        return mesh_lib.world_size()
    if not args.data_parallel:
        return 1
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    return local * (args.dist_num_processes or 1)


def check_world(args, world):
    """The JAX CLI's asserts on a world of `world` ranks, as ValueErrors:
    more than one needs --data_parallel, --seed (every rank draws the
    same global shuffle) and a global batch that divides over it."""
    if world > 1:
        if not args.data_parallel:
            raise ValueError(f"a world of {world} ranks needs --data_parallel")
        if args.seed is None:
            raise ValueError(f"a world of {world} ranks needs --seed, so that every "
                             "rank draws the same global shuffle")
    if args.batch_size % world:
        raise ValueError(f"the global batch {args.batch_size} does not divide over "
                         f"{world} ranks")


def check_prune_schedule(prune_every, prune_num, mask):
    """The JAX CLI's asserts on the prune schedule, as ValueErrors."""
    if prune_every > 0:
        if not prune_num > 0:
            raise ValueError("--prune_every needs --prune_num > 0")
        if mask == "loupe":
            raise ValueError("--prune_every: LOUPE prunes through its probability "
                             "mask (use --learn_mask), not the prune schedule")


def build_cfg(args) -> Config:
    cfg = Config()
    cfg.sparsity = args.sparsity
    cfg.lr = args.lr
    cfg.shape = args.crop
    cfg.coils = args.coils
    cfg.reg = args.reg
    cfg.mask = args.mask
    cfg.weight_smooth = args.smooth_weight
    cfg.weight_gan = args.gan_weight
    cfg.weight_gan_sim = args.gan_sim_weight
    cfg.weight_sim = args.sim_weight
    cfg.use_amp = args.use_amp
    if args.grad_accum > 1:
        cfg.grad_accum = args.grad_accum
    if args.learn_mask:
        # the differentiable soft sample in the step, so that gradients reach
        # the LOUPE logits (engine/csmodel.py)
        if args.mask != "loupe":
            raise ValueError("--learn_mask needs --mask loupe")
        if args.reg == "GAN-Only":
            # no recon loss reaches the logits under GAN-Only: the soft
            # sample would redraw the k-space noise every step while the
            # logits stay frozen
            raise ValueError("--learn_mask is inert under --reg GAN-Only (no recon "
                             "loss reaches the mask logits); use None, Rec or Mixed")
        cfg.learn_mask = True
    if args.net_scale == "tiny":
        # reduced nets for smoke runs; kept in the checkpoint's config, so
        # that eval rebuilds the same scale
        cfg.net_G_layers = (8, 16, 16)
        cfg.net_D_blocks = ((8,) * 2, (16,) * 2)
        cfg.net_T_layers = (8, 16, 16)
        cfg.net_R_cascades = 2
        cfg.net_R_chans = 4
        cfg.net_R_sens_chans = 4
        cfg.net_R_pools = 2
        cfg.net_R_sens_pools = 2
    return cfg


def latest_checkpoint(logdir):
    """The newest `ckpt_*.pt` under logdir/ckpt by mtime, and the iteration
    count its name holds."""
    ckpts = sorted(glob.glob(os.path.join(logdir, "ckpt", "ckpt_*.pt")), key=os.path.getmtime)
    if not ckpts:
        raise FileNotFoundError("no available ckpt found")
    name = os.path.basename(ckpts[-1])
    return ckpts[-1], int(name[len("ckpt_"):-len(".pt")])


def open_model(args, cfg, device):
    """The model the flags ask for; returns (model, iteration count,
    checkpoint path or None). `--seed` also seeds what a load builds fresh
    (the mask, the nets `--load_nets` leaves out); the model sets the
    process's conv and matmul precision to `--matmul_precision`."""
    seed = args.seed or 0
    build = dict(seed=seed, matmul_precision=args.matmul_precision)
    if args.resume is None:
        if args.load_nets is not None:
            raise ValueError("--load_nets needs --resume")
        print("training from scratch...")
        return CSModel(cfg=cfg, device=device, **build), 0, None
    iter_cnt = 0
    if args.resume == "":
        ckpt, iter_cnt = latest_checkpoint(args.logdir)
        print("will load latest ckpt from:", ckpt, ", cnt:", iter_cnt)
    else:
        ckpt = args.resume
        print("will load specified ckpt from:", ckpt)
    net = CSModel(cfg=cfg, ckpt=ckpt, objects=args.load_nets, device=device, **build)
    return net, iter_cnt, ckpt


def open_datasets(args, cfg):
    """(train slices, val slices, train volumes, val volumes) from the CSV
    manifests: train slices cropped to int(1.1 cfg.shape), for augmentation
    to deform before the crop, val slices to cfg.shape."""
    crop_train = int(cfg.shape * 1.1)
    if args.native_cache:
        # the CSVs compiled once into per-modality mmap caches, batches
        # assembled by the C++ OpenMP library; the mmap is the in-RAM store
        from ..data.native_cache import NativePairedSlices, build_caches_from_csv

        caches = {split: build_caches_from_csv(csv, args.protocals,
                                               os.path.join(args.native_cache, split))
                  for split, csv in (("train", args.train), ("val", args.val))}
        return (NativePairedSlices(caches["train"], crop=crop_train),
                NativePairedSlices(caches["val"], crop=cfg.shape), "?", "?")
    volumes_train = get_paired_volume_datasets(args.train, crop=crop_train,
                                               protocals=args.protocals)
    volumes_val = get_paired_volume_datasets(args.val, crop=cfg.shape, protocals=args.protocals)
    slices_train, slices_val = ConcatDataset(volumes_train), ConcatDataset(volumes_val)
    if args.prefetch:
        slices_train, slices_val = Prefetch(slices_train), Prefetch(slices_val)
    return slices_train, slices_val, len(volumes_train), len(volumes_val)


def _vis_batch(slices_val, device):
    """LEN_VIS val slices, picked by a fixed seed, stacked on `device`."""
    idx = np.random.default_rng(VIS_SEED).permutation(len(slices_val))[:LEN_VIS]
    items = [slices_val[int(i)] for i in idx]
    return [torch.from_numpy(np.stack([it[m] for it in items])).to(device)
            for m in range(len(items[0]))]


def rank_seed(seed, rank):
    """`seed` with `rank` folded in (the JAX CLI's `fold_in` of the process
    index): the augmentation draws of rank r's rows."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def run(net, slices_train, slices_val, args, writer=None, iter_cnt=0):
    """The epoch loop of the flags `args` on `net` from iteration
    `iter_cnt`; on a distributed `net` (`CSModel.distribute`), this rank's
    part of it (module docstring). Returns {"iter_cnt", "signal_end", "epochs": [{"epoch",
    "steps", "seconds" (the training part, host clock, loader and the
    card's work included), "val" (the mean val scalars or None),
    "val_loss"}], "scalars": [(tag, iteration, value), ...]: every scalar
    the loop logs, written to `writer` where there is one, "prunes":
    [(iteration, keep density), ...]}."""
    cfg = net.cfg
    prune_every = args.prune_every
    check_prune_schedule(prune_every, args.prune_num, cfg.get("mask"))
    device = net.device
    is_cuda = device.type == "cuda"
    mesh = net.mesh
    world, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    check_world(args, world)
    seed = args.seed if args.seed is not None else int(time.time())
    # the global batch, each rank loading its rows of it
    shards = dict(num_shards=world, shard_index=rank)
    loader_train = Loader(slices_train, args.batch_size // world, shuffle=True,
                          num_workers=args.num_workers, drop_last=True, seed=seed, **shards)
    loader_val = Loader(slices_val, args.batch_size // world, shuffle=False,
                        num_workers=args.num_workers, drop_last=True, **shards)
    # image grids need the whole val batch on one process: one rank only
    batch_vis = _vis_batch(slices_val, device) if world == 1 else None
    gen = torch.Generator(device=device).manual_seed(
        seed if world == 1 else rank_seed(seed, rank))
    history = []

    def log_scalars(prefix, scalars, it):
        for name, val in scalars.items():
            history.append((prefix + name, it, val))
            if writer is not None:
                writer.add_scalar(prefix + name, val, it)

    last_loss, last_ckpt, last_disp = 0, 0, 0
    signal_end = False
    iter_best = iter_cnt
    loss_best = None
    epochs, prunes = [], []
    ckpt_dir = os.path.join(args.logdir, "ckpt")
    time_start = time.time()
    for num_epoch in range(args.epoch):
        if signal_end:
            break
        # ------------------------------------------------------- training
        t0, steps = time.perf_counter(), 0
        batches = device_prefetch(iter(loader_train), device)
        while True:
            # --trace_at traces the whole iteration: the wait for its
            # batch, augmentation, the step and pruning
            prof = None
            if args.trace_at and iter_cnt + 1 == args.trace_at:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if is_cuda:
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            with span("san.data_wait"):
                batch = next(batches, None)
            if batch is None:  # the epoch's end: the traced iteration is the next epoch's first
                if prof is not None:
                    prof.stop()
                break
            net.train()
            time_data = time.time() - time_start
            iter_cnt += 1
            steps += 1
            draws = draw_augmentation(args.aux_aug, gen, batch[0].shape[0], len(batch), device)
            batch = [center_crop(x, (cfg.shape, cfg.shape))
                     for x in augment.augment_batch(args.aux_aug, batch, draws)]
            net.set_input(*batch)
            net.update()
            if prune_every > 0:
                # the JAX CLI's schedule (the reference exposes prune but
                # never schedules it): Taylor saliency every batch
                if cfg.get("mask") == "taylor":
                    net.taylor_step()
                if iter_cnt % prune_every == 0:
                    net.prune(args.prune_num)
                    density = 1.0 - float(net.pruned.float().mean())
                    prunes.append((iter_cnt, density))
                    print(f"\npruned at iter {iter_cnt}: keep density {density:.4f}",
                          flush=True)
            if prof is not None:
                if is_cuda:
                    torch.cuda.synchronize(device)
                prof.stop()
                trace = os.path.join(args.logdir, "trace")
                os.makedirs(trace, exist_ok=True)
                suffix = f"_rank{rank}" if world > 1 else ""
                prof.export_chrome_trace(
                    os.path.join(trace, f"iter_{iter_cnt:010d}{suffix}.json"))
                print(f"\nprofiler trace written to {trace}")
            time_start = time.time()

            if iter_cnt % SCALARS_EVERY == 0:
                last_loss = iter_cnt
                log_scalars("train/", net.get_vis("scalars")["scalars"], iter_cnt)
                if writer is not None:
                    for name, val in net.get_vis("histograms")["histograms"].items():
                        writer.add_histogram(tag="train/" + name, global_step=iter_cnt, **val)
            if batch_vis is not None and _due(iter_cnt, IMAGES_EVERY, IMAGES_EVERY_LATE):
                last_disp = iter_cnt
                net.eval()
                net.set_input(*batch_vis)
                net.test()
                for name, val in net.get_vis("images")["images"].items():
                    save_image(val, os.path.join(args.logdir, "res", "%010d_" % iter_cnt + name + ".jpg"),
                               nrow=LEN_VIS // COL_VIS, padding=10, value_range=(0, 1),
                               pad_value=0.5)
            if _due(iter_cnt, CKPT_EVERY, CKPT_EVERY_LATE):
                last_ckpt = iter_cnt
                net.save(os.path.join(ckpt_dir, "ckpt_%010d.pt" % iter_cnt),
                         with_opt=args.save_opt)
            if iter_cnt % SCALARS_EVERY == 0:
                postfix = f"[{iter_cnt}/{last_loss}/{last_disp}/{last_ckpt}]"
                if time_data >= DATA_STALL_S:  # a stall in the input pipeline
                    postfix += f" data {time_data:.1f}"
                print("\r" + postfix, end="", flush=True)
        if is_cuda:
            torch.cuda.synchronize(device)
        epoch = {"epoch": num_epoch, "steps": steps, "seconds": time.perf_counter() - t0,
                 "val": None, "val_loss": None}
        epochs.append(epoch)

        # ----------------------------------------------------- validation
        net.eval()
        stat_eval, stat_loss = [], []
        for batch in device_prefetch(iter(loader_val), device):
            batch = [center_crop(x, (cfg.shape, cfg.shape)) for x in batch]
            if mesh is not None:  # `test` takes the whole batch on every rank
                batch = mesh_lib.gather_rows(mesh, batch)
            net.set_input(*batch)
            stat_loss.append(net.test())
            stat_eval.append(net.get_vis("scalars")["scalars"])
        if not stat_eval:
            continue
        vis = {key: statistics.mean([x[key] for x in stat_eval]) for key in stat_eval[0]}
        log_scalars("val/", vis, iter_cnt)
        loss_current = statistics.mean(stat_loss)
        epoch.update(val=vis, val_loss=loss_current)
        print(f"\nepoch {num_epoch}: val {vis}")
        if args.intel_stop > 0:
            if loss_best is None or loss_current < loss_best:
                loss_best = loss_current
                iter_best = iter_cnt
                # ckpt_save replaces the old best.pt only once the new one
                # is written whole
                net.save(os.path.join(ckpt_dir, "best.pt"), with_opt=args.save_opt)
            elif iter_cnt >= args.intel_stop + iter_best:
                signal_end = True
                print("signal_end set due to intel_stop")

    print("reached end of training loop, and signal_end is " + str(signal_end))
    final = os.path.join(ckpt_dir, "ckpt_%010d.pt" % iter_cnt)
    if not os.path.exists(final):
        net.save(final, with_opt=args.save_opt)
        print("saved final ckpt:", final)
    return {"iter_cnt": iter_cnt, "signal_end": signal_end, "epochs": epochs,
            "scalars": history, "prunes": prunes}


def main(args, datasets=None):
    """The CLI on flags `args`: rank 0's `run` record, or None on a rank
    whose host does not hold rank 0. `datasets`: (train slices, val
    slices) in memory, in place of the manifests of --train and --val."""
    device = resolve_device(args.device)
    cfg = build_cfg(args)
    check_prune_schedule(args.prune_every, args.prune_num, cfg.mask)
    world = world_of(args, device)
    check_world(args, world)
    if args.data_parallel and not mesh_lib.in_world():
        return mesh_lib.launch(_main, args, datasets, device=device,
                               coordinator=args.dist_coordinator,
                               num_processes=args.dist_num_processes or 1,
                               process_id=args.dist_process_id or 0)
    return _main(mesh_lib.make_mesh(device=device) if args.data_parallel else None,
                 args, datasets)


def _main(mesh, args, datasets):
    """The CLI on one process: alone (mesh None) or as a rank of `mesh`."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0
    cfg = build_cfg(args)
    print(args)
    for path in (args.logdir, os.path.join(args.logdir, "res"), os.path.join(args.logdir, "ckpt")):
        os.makedirs(path, exist_ok=True)
    writer = None
    if rank0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(args.logdir)
        except Exception as e:  # noqa: BLE001 (TensorBoard is an optional log)
            print("tensorboard unavailable:", e)

    print("loading model...")
    try:
        return _train(mesh, args, datasets, cfg, device, writer)
    finally:
        f32_precision()  # the level of --matmul_precision holds for this run only
        if writer is not None:
            writer.flush()
            writer.close()


def _train(mesh, args, datasets, cfg, device, writer):
    """The model, the data and `run`, as `_main` sets them up."""
    net, iter_cnt, ckpt = open_model(args, cfg, device)
    if mesh is not None:
        net.distribute(mesh)
        print(f"data parallelism over {mesh.size} ranks ({mesh.backend}), rank {mesh.rank} "
              f"on {mesh.device}")
    print(net.cfg)
    if writer is not None:
        writer.add_text("date", repr(time.ctime()))
        writer.add_text("working dir", repr(os.getcwd()))
        writer.add_text("commands", repr(sys.argv))
        writer.add_text("arguments", repr(args))
        writer.add_text("actual config", repr(net.cfg))
        writer.add_text("ckpt", repr(ckpt))

    print("loading data...")
    if datasets is not None:
        slices_train, slices_val = datasets
        n_vol_train = n_vol_val = "?"
    else:
        slices_train, slices_val, n_vol_train, n_vol_val = open_datasets(args, net.cfg)
    print(f"done, {len(slices_train)} / {n_vol_train} for training, "
          f"{len(slices_val)} / {n_vol_val} for validation")
    print("training...")
    return run(net, slices_train, slices_val, args, writer, iter_cnt)


def try_int(v):
    try:
        v = int(v)
    except ValueError:
        v = int(float(v))
    if v < 0:
        raise argparse.ArgumentTypeError(f"{v} < 0")
    return v


def build_parser():
    parser = argparse.ArgumentParser(description="CS with adaptive mask (PyTorch/CUDA)")
    parser.add_argument("--logdir", metavar="logdir", type=str, required=True,
                        help="path for storage and checkpoint")
    parser.add_argument("--resume", type=str, default=None,
                        help="ckpt path; empty str loads the latest ckpt")
    parser.add_argument("--load_nets", type=str, nargs="*", default=None,
                        help="networks to load from the checkpoint")
    parser.add_argument("--epoch", type=int, default=150)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--num_workers", type=int, default=os.cpu_count())
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--intel_stop", type=try_int, default=0, metavar="N",
                        help="stop after val loss stalls for N iters")
    parser.add_argument("--reg", type=str, required=True,
                        choices=["None", "Rec", "Mixed", "GAN-Only"])
    parser.add_argument("--smooth_weight", type=float, required=True)
    parser.add_argument("--gan_weight", type=float, required=True)
    parser.add_argument("--gan_sim_weight", type=float, required=True)
    parser.add_argument("--sim_weight", type=float, required=True)
    parser.add_argument("--mask", metavar="type", required=True, type=str)
    parser.add_argument("--sparsity", metavar="0-1", type=float, default=None)
    parser.add_argument("--learn_mask", action="store_true",
                        help="train the LOUPE mask logits (needs --mask loupe)")
    parser.add_argument("--prune_every", type=int, default=0, metavar="N",
                        help="prune the mask every N iters (taylor/magnitude "
                             "masks; 0 = never)")
    parser.add_argument("--prune_num", type=int, default=0, metavar="K",
                        help="lines to prune per prune_every round")
    parser.add_argument("--train", metavar="/path/to/training_data", required=True, type=str)
    parser.add_argument("--val", metavar="/path/to/validation_data", required=True, type=str)
    parser.add_argument("--crop", type=int, default=320)
    parser.add_argument("--coils", type=int, default=1)
    parser.add_argument("--protocals", metavar="NAME", type=str, default=None, nargs="*")
    parser.add_argument("--aux_aug", type=str, required=True, choices=AUG_POLICIES)
    parser.add_argument("--prefetch", action="store_true")
    parser.add_argument("--native_cache", type=str, default=None, metavar="DIR",
                        help="compile the CSVs into native mmap slice caches "
                             "under DIR and assemble batches in C++ (OpenMP)")
    parser.add_argument("--use_amp", action="store_true",
                        help="compute in bf16 (parameters and checkpoints stay f32)")
    parser.add_argument("--grad_accum", type=int, default=1, metavar="K",
                        help="accumulate gradients over K micro-batches "
                             "(one optimizer step per global batch)")
    parser.add_argument("--force_gpu", action="store_true",
                        help="accepted for reference-CLI compatibility (no-op)")
    parser.add_argument("--net_scale", type=str, default="full", choices=["full", "tiny"],
                        help="tiny = reduced nets for smoke tests")
    parser.add_argument("--data_parallel", action="store_true",
                        help="data parallelism over every visible card (or the "
                             "world of torchrun, or of --dist_*)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed loader shuffling and augmentation RNG")
    parser.add_argument("--trace_at", type=int, default=0, metavar="N",
                        help="write a torch.profiler trace of all of iteration N "
                             "(the wait for its batch, augmentation, the step, "
                             "pruning) under logdir/trace")
    parser.add_argument("--save_opt", action="store_true",
                        help="include optimizer state in checkpoints")
    parser.add_argument("--dist_coordinator", type=str, default=None, metavar="HOST:PORT",
                        help="multi-host training: the rendezvous of process 0's host "
                             "(with --data_parallel, --dist_num_processes and "
                             "--dist_process_id)")
    parser.add_argument("--dist_num_processes", type=int, default=None,
                        help="multi-host training: the number of hosts (one CLI each)")
    parser.add_argument("--dist_process_id", type=int, default=None,
                        help="multi-host training: this host's index")
    parser.add_argument("--matmul_precision", type=str, default=None,
                        choices=list(MATMUL_PRECISIONS),
                        help="the f32 convs' and matmuls' precision, as JAX's on a GPU: "
                             "default and high run them in TF32, highest (and no flag) "
                             "in true f32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; no fallback to the CPU) or cpu")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
