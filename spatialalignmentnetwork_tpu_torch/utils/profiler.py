"""Per-network complexity / latency harness + trace capture (the
counterpart of the JAX package's `utils/profiler.py`).

Equivalent of the reference micro-benchmark (model.py:323-421, which uses
ptflops + CUDA-synced timing): for each of the four networks report
parameter count, counted FLOPs (`torch.utils.flop_counter`, the
counterpart of XLA's cost analysis: convolutions and matmuls, no FFT) and
the marginal time of one call anchored on a readback. Also exposes
`trace(logdir)` wrapping torch.profiler, whose trace TensorBoard's
profiler plugin and Perfetto read.

Usage: python -m spatialalignmentnetwork_tpu_torch.utils.profiler
       [--shape 320] [--batch 1] [--repeat 50] [--device cuda]
"""

import argparse
import contextlib

import numpy as np
import torch

from . import timing


@contextlib.contextmanager
def trace(logdir):
    """torch.profiler over the block (CPU, and CUDA where a card is),
    its trace written into `logdir` as `<host>_<pid>.<ns>.pt.trace.json`.
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    )
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _first_tensor(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def measure(fn, args, repeat=50, warmup=3):
    """Mean wall time per call: `timing.marginal_time` of a chain of
    `repeat` and `2 * repeat` calls, anchored on a device->host readback of
    a scalar of the last output (a CUDA call returns once its kernels are
    queued; the readback waits for everything queued on the stream)."""

    def make_chain(n):
        def chain(*a):
            out = None
            for _ in range(n):
                out = fn(*a)
            return _first_tensor(out).abs().sum()
        return chain

    for _ in range(warmup):
        fn(*args)
    return timing.marginal_time(make_chain, args, repeat, repeats=2)


def flops_of(fn, *args):
    """FLOPs of one call fn(*args) as PyTorch's operators count them
    (convolutions and matmuls; no FFT, no elementwise work, nothing for a
    hand-written kernel)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def param_count(module):
    return sum(p.numel() for p in module.parameters())


def nets(shape, batch, device, seed=0):
    """The four nets at the JAX package's profiler widths (NetD, NetG,
    NetT, NetR) in eval mode on `device`, each with its inputs: (name,
    module, args) triples."""
    from ..models.gan import NetD, NetG
    from ..models.stn import SpatialTransformer
    from ..models.varnet import VarNet

    rng = np.random.default_rng(seed)
    full = torch.as_tensor(
        (rng.random((batch, 1, shape, shape))
         + 1j * rng.random((batch, 1, shape, shape))).astype(np.complex64),
        device=device,
    )
    full_rss = full.abs()
    num_low = int(shape * 0.25 * 0.32)
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        rows = [
            ("NetD", NetD(generator=gen), (torch.cat([full_rss] * 2, dim=1),)),
            ("NetG", NetG(generator=gen), (full_rss,)),
            ("NetT", SpatialTransformer(channels=1), (full_rss, full_rss)),
            ("NetR", VarNet(num_cascades=8, sens_chans=8, sens_pools=4, chans=18,
                            pools=4, use_ref=True),
             (full, torch.ones(shape, dtype=torch.bool, device=device), full_rss, num_low)),
        ]
    return [(name, module.to(device).eval(), args) for name, module, args in rows]


def analytic_flops(shape, batch=1):
    """The FLOPs `flops_of` should count for a call of each net of `nets`
    at `shape` and `batch`: utils/flops.py's conv and transposed-conv
    terms, without its FFT and elementwise terms, which PyTorch's counter
    does not see."""
    from . import flops

    def convs(records):
        return batch * sum(r["flops"] for r in records if r["kind"] in ("conv", "convT"))

    sens, casc, edge = flops.varnet_convs(shape, 1, 8, 8, 4, 18, 4, True)
    return {"NetD": convs(flops.netd_convs(shape)), "NetG": convs(flops.netg_convs(shape)),
            "NetT": convs(flops.stn_convs(shape)),
            "NetR": convs(sens) + 8 * convs(casc) + convs(edge)}


def build_parser():
    p = argparse.ArgumentParser(description="per-net parameters, FLOPs and time")
    p.add_argument("--shape", type=int, default=320)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--repeat", type=int, default=50)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; no fallback to the CPU) or cpu")
    return p


def main(argv=None):
    """Print one line a net; returns the rows (name, parameters, FLOPs,
    seconds a call)."""
    from ..engine.csmodel import f32_precision, resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    f32_precision()
    rows = []
    with torch.inference_mode():
        for name, module, inputs in nets(args.shape, args.batch, device):
            rows.append((name, param_count(module), flops_of(module, *inputs),
                         measure(module, inputs, args.repeat)))
    for name, params, flops, latency in rows:
        gmacs = flops / 2 / 1e9
        print(f"{name}: {gmacs:.2f} GMac; {params/1e6:.2f} M parameters; "
              f"{latency*1000:.2f} ms time")
    return rows


if __name__ == "__main__":
    main()
