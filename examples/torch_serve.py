#!/usr/bin/env python3
"""Serving example for the PyTorch port: checkpoint -> reconstruction ->
torch.export artifact.

Demonstrates the deployment surface of `spatialalignmentnetwork_tpu_torch`:
  1. load a trained checkpoint (CSModel(ckpt=...));
  2. batch reconstruction through the serving path (CSModel.reconstruct:
     undersamples with the model's own mask and runs the ref-guided
     VarNet, eval semantics);
  3. optional data parallelism over the world this process is a rank of
     (--data_parallel: a world of 1 alone, torchrun's world under it), for
     the live path;
  4. export the recon step with torch.export (the grid sample a custom op
     of the graph, launching its CUDA kernel on the card), reload the
     artifact and check that it reproduces the live path.

With no --resume it trains a tiny synthetic model first (as
examples/torch_quickstart.py does, which needs `h5py`); with --resume it
needs no h5py. Runs on the card by default (no fallback):

    python examples/torch_serve.py [--device cuda|cpu] [--resume CKPT]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_checkpoint(workdir, device):
    """Train a tiny model on synthetic pairs; return the best.pt path."""
    from examples.torch_quickstart import make_data  # same synthetic anatomy
    from spatialalignmentnetwork_tpu_torch.engine import train as train_cli

    data = os.path.join(workdir, "data")
    os.makedirs(data, exist_ok=True)
    csv = make_data(data)
    logdir = os.path.join(workdir, "log")
    train_cli.main(train_cli.build_parser().parse_args([
        "--logdir", logdir, "--epoch", "1", "--batch_size", "2", "--num_workers", "2",
        "--intel_stop", "1", "--reg", "None", "--smooth_weight", "1000",
        "--gan_weight", "0.1", "--gan_sim_weight", "1", "--sim_weight", "1",
        "--mask", "equispaced", "--sparsity", "0.25", "--train", csv, "--val", csv,
        "--crop", "16", "--protocals", "T2", "T1", "--aux_aug", "None", "--prefetch",
        "--net_scale", "tiny", "--seed", "0", "--device", device,
    ]))
    return os.path.join(logdir, "ckpt", "best.pt")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to serve (default: train a tiny one)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback to the CPU) or cpu")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the live path's batch over the ranks of this "
                        "process's world")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.export import (
        export_reconstruct, load_exported,
    )

    with tempfile.TemporaryDirectory() as workdir:
        ckpt = args.resume or tiny_checkpoint(workdir, args.device)
        net = CSModel(ckpt=ckpt, device=args.device).eval()
        shape, coils = net.cfg.shape, net.cfg.coils

        mesh = None
        if args.data_parallel:
            from spatialalignmentnetwork_tpu_torch.parallel import mesh as mesh_lib

            mesh = mesh_lib.make_mesh(device=net.device)
            net.distribute(mesh)
            print(f"serving data-parallel over {mesh.size} rank(s) ({mesh.backend})")
        try:
            rng = np.random.default_rng(0)
            mk = lambda: torch.as_tensor(
                (rng.random((args.batch, coils, shape, shape))
                 + 1j * rng.random((args.batch, coils, shape, shape))).astype(np.complex64),
                device=net.device)
            full, aux = mk(), mk()

            rec = net.reconstruct(full, aux)
            print(f"reconstructed batch: {tuple(rec.shape)} {rec.dtype}, "
                  f"mean |rec| = {float(rec.abs().mean()):.4f}")

            # portable deployment artifact (weights inside it)
            path = os.path.join(workdir, "recon.pt2")
            blob = export_reconstruct(net, tuple(full.shape), path)
            print(f"exported torch.export artifact: {len(blob)} bytes")

            served = load_exported(path)
            with torch.inference_mode():
                rec2 = served(full, aux)
            np.testing.assert_allclose(rec2.cpu().numpy(), rec.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
            print("reloaded artifact matches the live serving path")
        finally:
            if mesh is not None:
                torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
