#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (CUDA_HOME or /usr/local/cuda) and `nvidia-smi`;
imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the path from csrc/, all at once;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes serving gives it and more (all padding modes, f32 and bf16,
     grids with out-of-range coordinates), then its time beside its plain
     version, the one-call PyTorch equivalent (a yardstick the port never
     calls) and its bound on an H100 SXM;
  4. full-width serving: `CSModel` at the default widths (320 x 320, 1
     coil, 4x equispaced), weights made from a numpy seed in the JAX
     package's checkpoint layout and carried over by `engine/from_jax`,
     synthetic phantoms in batches of 8; launch counts reset just before
     and read just after; slice 0 held against the same port on the CPU;
     slices/s from CUDA events and the peak device memory.

Prints one JSON `kernels` line and the nvidia-smi line before the last
line, and ends with {"ok": true, "device": {...}}. Exits non-zero, with
no result line, on any failure or when no card is available.
"""

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores

SHAPE = 320
BATCH = 8
WARMUP_REQUESTS = 2
TIMED_REQUESTS = 5
F32_ATOL = 1e-5  # kernel vs plain at f32: same arithmetic, rounding order only
BF16_RTOL = 2.0**-7  # one bf16 ulp: both round one f32 sum to bf16
SERVE_RTOL = 1e-3  # card vs CPU, end to end (cuDNN/cuFFT vs CPU sum order)
SERVE_ATOL_REL = 1e-4  # ... atol as a fraction of max |CPU output|


def log(*args):
    print(*args, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def build_kernels(sources):
    """One nvcc per source, all started together."""
    from spatialalignmentnetwork_tpu_torch import kernels

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        results = dict(zip(sources, pool.map(kernels.build, sources)))
    secs = time.perf_counter() - t0
    for src, (lib, compiler_log) in results.items():
        regs = [ln.strip() for ln in compiler_log.splitlines() if "registers" in ln]
        log(f"built {src} -> {lib}: {regs}")
    log(f"kernel build: {secs:.2f} s for {len(sources)} source(s)")


# ----------------------------------------------------------------- inputs
def smooth_field(rng, n, h, w, coarse=10):
    """Smooth random field [n, h, w, 2]: a coarse normal grid upsampled
    bilinearly (numpy seed, built on the CPU)."""
    import torch
    import torch.nn.functional as F

    c = torch.from_numpy(rng.standard_normal((n, 2, coarse, coarse)).astype(np.float32))
    f = F.interpolate(c, size=(h, w), mode="bilinear", align_corners=True)
    return f.permute(0, 2, 3, 1).contiguous()


def sample_grid(rng, n, h, w):
    """Identity plus smooth offsets of ~0.05 (8 px at 320) and a shift of
    0.02 to one side, so the borders sample beyond +-1."""
    from spatialalignmentnetwork_tpu_torch.ops.grid_sample import identity_grid

    shift = np.array([0.02, -0.02], np.float32) * rng.choice([-1, 1], 2)
    off = smooth_field(rng, n, h, w) * 0.05 + float(shift[0])
    off[..., 1] += float(shift[1] - shift[0])
    return (identity_grid((n, 1, h, w)) + off).contiguous()


def phantoms(rng, n, size, coils=1):
    """Pairs of synthetic head-like phantoms: target (complex, smooth
    phase) and reference modality (other contrast, shifted geometry)."""
    yy, xx = np.mgrid[-1:1:size * 1j, -1:1:size * 1j].astype(np.float32)
    full = np.zeros((n, coils, size, size), np.complex64)
    aux = np.zeros((n, coils, size, size), np.complex64)
    for b in range(n):
        t2 = np.zeros((size, size), np.float32)
        t1 = np.zeros((size, size), np.float32)
        dx, dy = rng.normal(0, 0.03, 2)
        for e in range(12):
            cx, cy = rng.uniform(-0.5, 0.5, 2) * (0.3 if e == 0 else 1)
            ax, ay = rng.uniform(0.1, 0.4, 2) * (2.2 if e == 0 else 1)
            th = rng.uniform(0, np.pi)
            for img, ddx, ddy, val in ((t2, 0, 0, rng.uniform(0.2, 1)),
                                       (t1, dx, dy, rng.uniform(0.2, 1))):
                u = (xx - cx - ddx) * np.cos(th) + (yy - cy - ddy) * np.sin(th)
                v = -(xx - cx - ddx) * np.sin(th) + (yy - cy - ddy) * np.cos(th)
                img[(u / ax) ** 2 + (v / ay) ** 2 <= 1] = val
        phase = np.exp(1j * np.pi * 0.3 * (xx * rng.normal() + yy * rng.normal()))
        for c in range(coils):
            full[b, c] = t2 * phase
            aux[b, c] = t1 * phase
    return full, aux


# ------------------------------------------------------------- kernels
def time_ms(fn, arg_sets, iters=20, warmup=5):
    """Device ms per call: CUDA events around `iters` calls cycling through
    `arg_sets` (more bytes than the 50 MB L2, so each call reads cold
    inputs). The calls are queued behind a device sleep of 2e8 cycles
    (about 0.1 s), so the card runs them back to back and the host's launch
    overhead is not timed."""
    import torch

    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_grid_sample(rng):
    """Kernel vs plain on the card; returns its `kernels` entry (without
    the launch count)."""
    import torch
    import torch.nn.functional as F

    from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs

    dev = torch.device("cuda")
    max_err = 0.0
    for c in (1, 2):
        img = torch.from_numpy(
            rng.standard_normal((BATCH, c, SHAPE, SHAPE)).astype(np.float32)
        ).to(dev)
        grid = sample_grid(rng, BATCH, SHAPE, SHAPE).to(dev)
        outside = float((grid.abs() > 1).float().mean())
        for mode in kgs.PADDING_MODES:
            got = kgs.grid_sample_cuda(img, grid, mode)
            want = kgs.grid_sample_plain(img, grid, mode)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= F32_ATOL:
                raise AssertionError(f"grid_sample f32 C={c} {mode}: {err}")
            max_err = max(max_err, err)
            imgb = img.to(torch.bfloat16)
            gotb = kgs.grid_sample_cuda(imgb, grid, mode).float()
            wantb = kgs.grid_sample_plain(imgb, grid, mode).float()
            torch.cuda.synchronize()
            errb = float((gotb - wantb).abs().max())
            torch.testing.assert_close(gotb, wantb, rtol=BF16_RTOL, atol=0.0)
            log(f"grid_sample C={c} {mode:10s}: f32 max|kernel-plain| {err:.3g} "
                f"(tol {F32_ATOL}), bf16 {errb:.3g} (tol rtol {BF16_RTOL}); "
                f"{outside:.4f} of grid coords beyond +-1")

    # time at the serving shape: warp of |aux| [8, 1, 320, 320], zeros
    sets = []
    for _ in range(6):  # 6 x 13.1 MB > 50 MB of L2
        img = torch.from_numpy(
            rng.standard_normal((BATCH, 1, SHAPE, SHAPE)).astype(np.float32)
        ).to(dev)
        sets.append((img, sample_grid(rng, BATCH, SHAPE, SHAPE).to(dev)))
    fns = {
        "plain": lambda i, g: kgs.grid_sample_plain(i, g, "zeros"),
        "kernel": lambda i, g: kgs.grid_sample_cuda(i, g, "zeros"),
        "library": lambda i, g: F.grid_sample(
            i, g, mode="bilinear", padding_mode="zeros", align_corners=False),
    }
    times = {k: [] for k in fns}
    for order in (("plain", "kernel", "library"), ("library", "kernel", "plain")):
        for k in order:
            times[k].append(time_ms(fns[k], sets))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    n, c, h, w = sets[0][0].shape
    out_px = n * SHAPE * SHAPE
    nbytes = 4 * n * c * h * w + 8 * out_px + 4 * c * out_px
    flops = out_px * (18 + 7 * c)  # coordinates + weights, 4 taps per channel
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    log(f"grid_sample timing [8,1,320,320] f32 zeros: {times} ms; "
        f"bound {bound * 1e3:.2f} us ({nbytes / 1e6:.1f} MB)")
    return {
        "name": kgs.NAME,
        "route": "cuda",
        "source": "spatialalignmentnetwork_tpu_torch/csrc/grid_sample.cu",
        "replaces": "spatialalignmentnetwork_tpu/ops/pallas/grid_sample.py:222",
        "max_abs_err": max_err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
        else "operations",
        "library_ms": ms["library"],
    }


# ------------------------------------------------------------- serving
def serving_cfg(shape=SHAPE):
    """The flagship configuration at CSModel's default widths."""
    from spatialalignmentnetwork_tpu_torch.engine.config import Config

    return Config(shape=shape, coils=1, mask="equispaced", sparsity=0.25)


def random_entries(model, rng):
    """Checkpoint entries for net_T and net_R in the JAX package's layout
    (flax names, HWIO kernels, cascades stacked), from a numpy seed."""
    from spatialalignmentnetwork_tpu_torch.engine import from_jax

    def make(module, entries, n_stack):
        sd = module.state_dict()
        entry = {}
        for tkey, jkey, cascade, kind in entries:
            if jkey in entry:
                continue
            shape = from_jax.to_jax_layout_shape(sd[tkey].shape, kind)
            if cascade is not None:
                shape = (n_stack, *shape)
            if jkey.endswith("/kernel"):
                fan_in = int(np.prod(shape[-4:-1]))
                a = rng.standard_normal(shape) * np.sqrt(1.0 / fan_in)
            elif jkey.endswith("/var"):
                a = rng.uniform(0.5, 1.5, shape)
            elif jkey.endswith("/scale"):
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            elif jkey.endswith("dc_weight"):
                a = rng.uniform(0.5, 1.5, shape)
            else:  # biases, BN means
                a = 0.05 * rng.standard_normal(shape)
            entry[jkey] = a.astype(np.float32)
        return entry

    net_t = make(model.net_T, from_jax.stn_entries(model.net_T), 0)
    # the STN head is zero-init in training; here it is small but non-zero,
    # with a bias that moves every sample off the pixel grid and the
    # borders beyond +-1
    head = net_t["params/Conv_0/kernel"]
    net_t["params/Conv_0/kernel"] = head * 0.05
    net_t["params/Conv_0/bias"] = np.array([0.0213, -0.0171], np.float32)
    cascades = len(model.net_R.cascades)
    net_r = make(model.net_R, from_jax.varnet_entries(
        cascades,
        len(model.net_R.sens_net.norm_unet.unet.down_sample_layers),
        len(model.net_R.cascades[0].model.unet.down_sample_layers),
    ), cascades)
    return {"net_T": net_t, "net_R": net_r}


def check_serving(rng, device="cuda", shape=SHAPE, batch=BATCH):
    """Serve WARMUP + TIMED requests of `batch` slices; returns the launch
    counts of that run. (The CPU tests run it at a small shape on the CPU,
    where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    cfg = serving_cfg(shape)
    model = CSModel(cfg=cfg, device=device, seed=0)
    entries = random_entries(model, rng)
    model.load_entries(entries)
    log(f"serving model: {sum(p.numel() for p in model.net_T.parameters())} "
        f"net_T params, {sum(p.numel() for p in model.net_R.parameters())} "
        f"net_R params, {len(model.net_R.cascades)} cascades, "
        f"{int((~model.pruned).sum())}/{shape} lines kept, "
        f"num_low {model.num_low_frequencies}")
    requests = [phantoms(rng, batch, shape) for _ in range(WARMUP_REQUESTS + TIMED_REQUESTS)]

    with torch.inference_mode():  # how far the warp moves samples
        aux = torch.as_tensor(requests[0][1], device=model.device)
        offset, grid = model.net_T(aux.abs(), aux.abs())
        px = ((grid[..., 0] + 1) * shape - 1) / 2
        log(f"STN grid: {float((grid.abs() > 1).float().mean()):.4f} of coords "
            f"beyond +-1, frac(x px) mean {float((px - px.floor()).mean()):.3f}, "
            f"offset min/max {float(offset.min()):.4f}/{float(offset.max()):.4f}")

    is_cuda = model.device.type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs = []
    for full, aux in requests[:WARMUP_REQUESTS]:
        outs.append(model.reconstruct(full, aux))
    if is_cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for full, aux in requests[WARMUP_REQUESTS:]:
        outs.append(model.reconstruct(full, aux))
    if is_cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    n_req = len(requests)
    for out in outs:
        if out.shape != (batch, 1, shape, shape) or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)}")
    slices_per_s = TIMED_REQUESTS * batch / secs
    log(f"serving on {model.device}: {n_req} requests of {batch} slices "
        f"({WARMUP_REQUESTS} warm-up), {secs * 1e3 / TIMED_REQUESTS:.2f} ms "
        f"per request, {slices_per_s:.2f} slices/s; launches {launches}")
    if is_cuda:
        log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if launches.get("grid_sample_fwd", 0) != n_req:
            raise AssertionError(
                f"grid_sample kernel launched {launches} times for {n_req} requests"
            )

    # slice 0 of the first request against the same port on the CPU
    ref_model = CSModel(cfg=cfg, device="cpu", seed=0)
    ref_model.load_entries(entries)
    full, aux = requests[0]
    ref = ref_model.reconstruct(full[:1], aux[:1])[0]
    got = outs[0][0].cpu()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"card vs CPU, slice 0: max|diff| {err:.4g}, max|ref| {scale:.4g} "
        f"(tol rtol {SERVE_RTOL}, atol {SERVE_ATOL_REL} x max|ref|)")
    torch.testing.assert_close(got, ref, rtol=SERVE_RTOL,
                               atol=SERVE_ATOL_REL * scale)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    build_kernels(["grid_sample.cu"])
    rng = np.random.default_rng(0)
    entries = [check_grid_sample(rng)]
    launches = check_serving(rng)
    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was not launched on the main path")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in order} for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
