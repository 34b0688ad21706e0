#!/usr/bin/env python3
"""Quickstart for the PyTorch port: synthesize paired volumes, train
briefly, evaluate.

Demonstrates the whole surface of `spatialalignmentnetwork_tpu_torch`:
data prep -> train CLI -> checkpoint -> eval CLI -> metrics, with the
flags going through the CLIs' own parsers. Runs on the card by default
(no fallback); `--device cpu` runs it anywhere. Writing the h5 volumes
needs `h5py`.

    python examples/torch_quickstart.py [--epochs N] [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_data(root, volumes=2, slices=6, size=24):
    """Paired T1/T2 h5 volumes under `root` and their CSV manifest; returns
    the manifest's path."""
    import h5py

    rng = np.random.default_rng(0)
    rows = []
    for v in range(volumes):
        # smooth synthetic anatomy: the T1/T2 pair shares structure with
        # different contrast, like the real task
        base = rng.random((slices, size, size)).astype(np.float32)
        for _ in range(3):
            base = (base + np.roll(base, 1, -1) + np.roll(base, 1, -2)) / 3
        for proto, img in (("T1", base), ("T2", base**2)):
            img = img / img.max()
            with h5py.File(os.path.join(root, f"p{v}_{proto}.h5"), "w") as h5:
                h5.create_dataset("image", data=img.astype(np.float32))
                h5.attrs["max"] = 1.0
                h5.attrs["acquisition"] = proto
        rows.append(f"p{v}_T1.h5,p{v}_T2.h5")
    csv = os.path.join(root, "pairs.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback to the CPU) or cpu")
    p.add_argument("--workdir", type=str, default=None,
                   help="where the data and the logs go (default: a new "
                        "temporary directory)")
    return p


def main(argv=None):
    """Returns (the final checkpoint, the eval CLI's mean scalars)."""
    args = build_parser().parse_args(argv)
    root = args.workdir or tempfile.mkdtemp(prefix="san_quickstart_")
    os.makedirs(root, exist_ok=True)
    csv = make_data(root)
    logdir = os.path.join(root, "log")

    from spatialalignmentnetwork_tpu_torch.engine import eval as eval_cli
    from spatialalignmentnetwork_tpu_torch.engine import train as train_cli

    train_cli.main(train_cli.build_parser().parse_args([
        "--logdir", logdir, "--epoch", str(args.epochs), "--batch_size", "4",
        "--num_workers", "2", "--reg", "Rec", "--smooth_weight", "1000",
        "--gan_weight", "0.1", "--gan_sim_weight", "1", "--sim_weight", "1",
        "--mask", "equispaced", "--sparsity", "0.25", "--train", csv, "--val", csv,
        "--crop", "16", "--protocals", "T2", "T1", "--aux_aug", "PBSpline",
        "--prefetch", "--net_scale", "tiny", "--seed", "0", "--device", args.device,
    ]))

    ckpts = sorted(os.listdir(os.path.join(logdir, "ckpt")))
    final = os.path.join(logdir, "ckpt", ckpts[-1])
    print("\nevaluating", final)
    scalars = eval_cli.main(eval_cli.build_parser().parse_args([
        "--resume", final, "--val", csv, "--crop", "16", "--protocals", "T2", "T1",
        "--device", args.device,
    ]))
    return final, scalars


if __name__ == "__main__":
    main()
