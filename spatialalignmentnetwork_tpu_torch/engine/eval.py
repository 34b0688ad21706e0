"""The eval CLI (counterpart of the JAX package's `engine/eval.py`, which
mirrors the reference's eval.py).

    python -m spatialalignmentnetwork_tpu_torch.engine.eval \
        --resume CKPT --val pairs.csv --protocals T2 T1 \
        [--metric metrics.json] [--save DIR] [--aux_aug 1.0] [--bucket 16] \
        [--matmul_precision {default,high,highest}] [--device cuda]

Loads a checkpoint in any layout `engine/checkpoint.py` reads (its config
comes from inside it, so a checkpoint trained with `use_amp` evaluates
under the bf16 policy, as in the JAX CLI, which has no flag for it), runs `CSModel.test` on each volume of the CSV as
one batch, padded to a multiple of `--bucket` slices (pad slices are left
out of every scalar), optionally misaligns the reference modality by a
scaled random deformation first (`--aux_aug factor`), and writes the
per-volume metrics JSON and, with `--save`, the volumes and the
displacement grid (NIfTI where nibabel is installed, .npy otherwise).

`evaluate` is the loop itself, on volumes in memory or read from h5
files: volume i+1 is staged (host stack, bucket pad, and a copy from
pinned host memory that does not block) and its step dispatched before
volume i's scalars are read back, so that the copies and the host's
readbacks overlap the card's work.

`--data_parallel` (the JAX CLI's "batched 3-D volumes sharded across a
slice" configuration) evaluates as the ranks of a torch.distributed world
(`parallel/mesh.py`): one process a visible card (the CPU counts as one)
spawned by the CLI, or the world of torchrun. Every rank stages each
whole volume, `CSModel.test` shards its bucket-padded slices over the
ranks and gathers the results, and rank 0 prints and writes the metrics
and `--save`. The `--aux_aug` generator takes rank 0's clock seed, so
that every rank warps its slices by the same draw.

`--matmul_precision` takes the JAX CLI's levels with JAX's meaning on a
GPU: "default" and "high" run the nets' f32 convs and matmuls in TF32,
"highest" in true f32, which is also the policy without the flag
(`engine/csmodel.py::set_matmul_precision`). The level holds for the
CLI's run; the metrics file's `meta` records it.

Runs on the card unless `--device cpu` is asked for; with no card and no
`--device cpu` it raises.
"""

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from ..data import augment
from ..data.loader import to_device
from ..data.paired_dataset import get_paired_volume_datasets
from ..ops.crop import center_crop
from ..parallel import mesh as mesh_lib
from .csmodel import MATMUL_PRECISIONS, CSModel, f32_precision, resolve_device

AFFINE = np.eye(4) * [0.7, -0.7, -5, 1]  # the reference's NIfTI affine
SAVED = (("image", "img_full_rss"), ("aux", "img_aux_rss"),
         ("sampled", "img_sampled_rss"), ("warped", "img_warped_rss"),
         ("rec", "img_rec"))


def _bucket_pad(arrays, bucket):
    """Pad [S, ...] numpy arrays to the next multiple of `bucket` along the
    slice axis, keeping forwardG's half split: the first ceil(S/2) slices
    stay at the front and the rest start at ceil(P/2) (the test step
    splits its batch at n1 = ceil(n/2), as the reference's torch.chunk).

    Returns (padded_arrays, valid [P] float32, restore_indices [S])."""
    s = arrays[0].shape[0]
    p = -(-s // bucket) * bucket
    if p == s:
        return arrays, np.ones(s, np.float32), np.arange(s)
    n1s, n1p = (s + 1) // 2, (p + 1) // 2
    idx = np.concatenate([np.arange(n1s), n1p + np.arange(s - n1s)])
    valid = np.zeros(p, np.float32)
    valid[idx] = 1.0
    out = []
    for a in arrays:
        padded = np.zeros((p,) + a.shape[1:], a.dtype)
        padded[:n1s] = a[:n1s]
        padded[n1p:n1p + (s - n1s)] = a[n1s:]
        out.append(padded)
    return out, valid, idx


def _save_volume(arr, path, affine=AFFINE):
    """Save [S, H, W] (or the [3, 1, S, H, W] grid) as NIfTI where nibabel
    is installed, else as `path`.npy."""
    try:
        import nibabel as nib
    except ImportError:
        np.save(path + ".npy", np.asarray(arr))
        return
    nib.save(nib.Nifti1Image(np.asarray(arr).T, affine), path)


def _save_outputs(images, restore, save, i, shape):
    """Volume i's images and displacement grid (in pixels, a zero third
    component) under `save`, the pad slices dropped."""
    grid = images["img_offset"][restore]  # [S, H, W, 2]
    grid = np.stack([grid[..., 0], grid[..., 1], np.zeros_like(grid[..., 0])],
                    axis=-1) * (shape - 1) / 2
    _save_volume(np.transpose(grid, (3, 0, 1, 2))[:, None], f"{save}/{i}_grid.nii")
    for name, key in SAVED:
        _save_volume(images[key][restore][:, 0], f"{save}/{i}_{name}.nii")


def evaluate(net, volumes, bucket=16, aux_aug=-1.0, save=None, draws=None):
    """Score each volume with `net.test` (net in eval mode); returns the
    per-volume scalars, a list of {'loss_*' / 'metric_*': float}.

    volumes: a sequence of volumes, each a sequence of slices [target,
    aux] (complex [C, H, W] numpy arrays, as `AlignedVolumesDataset`
    yields them). bucket: pad each volume's slices to a multiple of it (0:
    no padding). aux_aug > 0: warp each volume's reference by a random
    rigid + B-spline deformation scaled by that factor, on the card, then
    crop both to cfg.shape; `draws` gives each volume's draws (a list of
    `augment.draw` dicts of the padded slice count), else they come from a
    generator on the model's device seeded by the clock. save: a
    directory for the volumes and grids, or None. On a distributed `net`
    (`CSModel.distribute`) every rank runs the loop on every volume, the
    generator seeded by rank 0's clock, and rank 0 alone prints and
    saves; every rank returns the scalars."""
    cfg = net.cfg
    device = net.device
    rank0 = net.mesh is None or net.mesh.rank == 0
    gen = None
    if aux_aug > 0 and draws is None:
        seed = int(time.time())
        if net.mesh is not None:
            seed = mesh_lib.broadcast_int(net.mesh, seed)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    stat_eval = []

    def stage(volume):
        """Host stack + bucket pad + a non-blocking copy for one volume."""
        host = [np.stack(s, axis=0) for s in zip(*[volume[j] for j in range(len(volume))])]
        if bucket > 0:
            host, valid, restore = _bucket_pad(host, bucket)
            valid = to_device(valid, device)
        else:
            valid, restore = None, np.arange(host[0].shape[0])
        return [to_device(x, device) for x in host], valid, restore

    def collect(i, kept, restore):
        """Host readbacks for a volume whose step was already dispatched."""
        keys = [k for k in kept if k.startswith(("loss_", "metric_"))]
        scalars = dict(zip(keys, torch.stack([kept[k] for k in keys]).cpu().tolist()))
        stat_eval.append(scalars)
        if not rank0:
            return
        print(f"volume {i}: " + str({k: round(v, 4) for k, v in scalars.items()}),
              flush=True)
        if save is not None:
            images = {k: v.cpu().numpy() for k, v in kept.items() if k.startswith("img_")}
            _save_outputs(images, restore, save, i, cfg.shape)

    pending = None
    staged = stage(volumes[0]) if len(volumes) else None
    for i in range(len(volumes)):
        batch, valid, restore = staged
        staged = stage(volumes[i + 1]) if i + 1 < len(volumes) else None
        if aux_aug > 0:
            img_full, img_aux = batch
            d = draws[i] if draws is not None else augment.draw(gen, img_aux.shape[0], device)
            img_aux = augment.scaled_deformation(img_aux, aux_aug, d)
            batch = [center_crop(x, (cfg.shape, cfg.shape)) for x in (img_full, img_aux)]
        net.set_input(*batch)
        net.test(valid=valid, sync=False)
        # keep only what collect() reads: a previous volume's images stay
        # on the card through the next step otherwise
        kept = {k: v for k, v in net._aux.items() if k.startswith(("loss_", "metric_"))}
        if save is not None:
            kept.update({key: net._aux[key] for _, key in SAVED + (("grid", "img_offset"),)})
        if pending is not None:
            collect(*pending)
        pending = (i, kept, restore)
    if pending is not None:
        collect(*pending)
    return stat_eval


def main(args):
    """The CLI on flags `args`: the mean scalars (rank 0's, or None on a
    host that does not hold rank 0)."""
    device = resolve_device(args.device)
    if args.data_parallel and not mesh_lib.in_world():
        return mesh_lib.launch(_main, args, device=device)
    return _main(mesh_lib.make_mesh(device=device) if args.data_parallel else None, args)


def _main(mesh, args):
    """The CLI on one process: alone (mesh None) or as a rank of `mesh`."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0
    print(args)
    if rank0 and args.save is not None:
        os.makedirs(args.save, exist_ok=True)
    if rank0 and args.metric is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.metric)), exist_ok=True)
    # FileNotFoundError if absent
    net = CSModel(ckpt=args.resume, device=device, matmul_precision=args.matmul_precision)
    print("load ckpt from:", args.resume)
    try:
        return _score(net, mesh, args, device, rank0)
    finally:
        f32_precision()  # the level holds for this run only


def _score(net, mesh, args, device, rank0):
    """The CLI's volumes scored by `net`; the metrics file written."""
    cfg = net.cfg
    crop = int(cfg.shape * 1.1) if args.aux_aug > 0 else cfg.shape
    volumes = get_paired_volume_datasets(args.val, crop=crop, protocals=args.protocals)
    net.eval()
    if mesh is not None:
        net.distribute(mesh)
        print(f"data parallelism over {mesh.size} ranks ({mesh.backend}), rank {mesh.rank} "
              f"on {mesh.device}")
    stat_eval = evaluate(net, volumes, args.bucket, args.aux_aug, args.save)
    # raise before writing the metrics file: a misconfigured --val must not
    # leave a present-but-empty file behind
    if not stat_eval:
        raise ValueError(f"no volumes found in {args.val}")
    if rank0 and args.metric is not None:
        meta = {
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu"),
            "torch": torch.__version__,
            "checkpoint": os.path.abspath(args.resume),
            "matmul_precision": args.matmul_precision,
        }
        if mesh is not None:
            meta["ranks"] = mesh.size
        with open(args.metric, "w") as f:
            json.dump({"meta": meta, "volumes": stat_eval}, f)
    vis = {key: statistics.mean([x[key] for x in stat_eval]) for key in stat_eval[0]}
    if rank0:
        print(vis)
    return vis


def build_parser():
    parser = argparse.ArgumentParser(description="CS evaluation (PyTorch/CUDA)")
    parser.add_argument("--resume", type=str, required=True, help="checkpoint path")
    parser.add_argument("--save", default=None, metavar="/path/to/save", type=str,
                        help="path to save evaluated data")
    parser.add_argument("--metric", default=None, metavar="/path/to/metric", type=str,
                        help="path to save metrics JSON")
    parser.add_argument("--val", metavar="/path/to/evaluation_data", required=True,
                        type=str)
    # accepted and unused, as in the reference: its eval.py defines --crop
    # (eval.py:110) but takes the crop from the checkpoint's cfg.shape
    parser.add_argument("--crop", type=int, default=320)
    parser.add_argument("--protocals", metavar="NAME", type=str, default=None, nargs="*")
    parser.add_argument("--aux_aug", type=float, default=-1,
                        help="scaled misalignment factor; -1 disables")
    parser.add_argument("--bucket", type=int, default=16,
                        help="pad each volume's slice axis to a multiple of this "
                             "(pad slices are left out of the metrics); 0 disables")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard each volume's slices over every visible card "
                             "(or the world of torchrun)")
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
