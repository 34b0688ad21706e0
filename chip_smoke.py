#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, its
registration-loss library and its 3x3 conv on one NVIDIA GPU and check
them.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (CUDA_HOME or /usr/local/cuda) and `nvidia-smi`;
imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the paths from csrc/, one nvcc per source,
     all at once; read the conv and MI libraries' SASS (cuobjdump) and
     ptxas logs: tensor-core HMMA in every conv kernel instance (TF32 ones
     in the f32 kernels, bf16 ones in the bf16 kernels) and TF32 ones in
     the MI kernels' products, no spills in any of their kernels; the
     SSIM and LNCC libraries' ptxas logs: no spills;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the paths give it and more (all padding modes, C = 2, a
     non-square plane, augmentation's 352 plane, an output plane of odd
     width and odd size, a grid only 8-byte aligned, the smallest SSIM and
     LNCC planes, grids with out-of-range coordinates, MI values outside
     the bin range and 2, 32 and 33 bins, the MI backward near the top bin
     held to float64, its bits run to run and at ragged pixel counts from
     inputs that end where mapped memory ends (phases 2 and 3 for MI
     alone: `python3 -c "import chip_smoke; chip_smoke.mi_phases()"`); the
     SSIM and LNCC forwards' and backwards' bits run to run on every case,
     the LNCC forward on the phantoms against float64, and the backwards'
     peak device memory (phases 2 and 3 for SSIM and LNCC alone, with all
     four kernels timed at 160 and 80 too and each launch's device time:
     `python3 -c "import chip_smoke; chip_smoke.loss_phases()"`); the
     3x3 conv forward and input gradient, f32 and bf16, held
     to float64 on every conv of the ladder of phase 9 and on ragged
     planes, channels and batches), then its time beside its plain version, the one-call PyTorch equivalent where
     there is one (a yardstick the port never calls) and its bound on an
     H100 SXM;
  4. full-width serving: `CSModel` at the default widths (320 x 320, 1
     coil, 4x equispaced), weights made from a numpy seed in the JAX
     package's checkpoint layout and carried over by `engine/from_jax`,
     synthetic phantoms in batches of 8; launch counts reset just before
     and read just after; slice 0 held against the same port on the CPU;
     slices/s from CUDA events and the peak device memory;
  5. the Rec train step at full width, batch 4: 2 warm-up and 3 timed
     `update()`s, launch counts reset just before and read just after
     (one grid_sample forward, one d_grid, one SSIM forward and backward a
     step, no d_img), every loss finite, net_T moved and reached by the
     warp's gradient; ms per step, slices/s, peak device memory;
  6. autograd on the card against the CPU: ssimloss(target, warp(img,
     grid)) with both img and grid learnable, the path that launches the
     d_img kernel;
  7. one train step on the card against the same step on the CPU: the
     losses, and every parameter's gradient held to the same step in
     float64 on the CPU;
  8. the registration losses at full width: lncc_loss, ms_lncc_loss,
     mi_loss and ms_mi_loss of the target phantoms against the aux
     phantoms warped by a learnable grid ([4, 1, 320, 320]), forward and
     backward to image and grid, with cuDNN's TF32 at PyTorch's default
     (the ms pyramid pins f32 itself); launch counts reset just before
     and read just after (each loss launches its forward and backward
     kernel once a scale); card against the CPU; ms per call;
  9. the conv ladder at full width (phases 2, 3 and 9 for the conv alone:
     `python3 -c "import chip_smoke; chip_smoke.conv_phases()"`):
     `conv3x3_s2d` forward and backward
     (f32) and forward (bf16) on every distinct 3x3 conv of one cascade
     NormUnet and of the sensitivity NormUnet at batch 8 and 320 x 320,
     launch counts reset just before and read just after (exactly 2 f32
     launches a shape: the forward and the input gradient), outputs and
     gradients held to float64; then each shape's kernel time beside
     cuDNN's (`F.conv2d` on a channels-last view, TF32 off; a yardstick
     the port never calls), cuDNN's with TF32 on (f32; information for the
     nets' TF32 decision, not the yardstick) and its bound, and one
     cascade's totals.

Prints one JSON `kernels` line and the nvidia-smi line before the last
line, and ends with {"ok": true, "device": {...}}. Exits non-zero, with
no result line, on any failure or when no card is available.
"""

import concurrent.futures
import contextlib
import ctypes
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12  # tensor cores, dense
BF16_FLOPS = 989e12  # tensor cores, dense
# the f32 conv runs 3xTF32: three TF32 products an f32 product
F32X3_FLOPS = TF32_FLOPS / 3

SHAPE = 320
BATCH = 8
WARMUP_REQUESTS = 2
TIMED_REQUESTS = 5
TRAIN_BATCH = 4
WARMUP_STEPS = 2
TIMED_STEPS = 3
F32_ATOL = 1e-5  # kernel vs plain at f32: same arithmetic, rounding order only
BF16_RTOL = 2.0**-7  # one bf16 ulp: both round one f32 sum to bf16
SERVE_RTOL = 1e-3  # card vs CPU, end to end (cuDNN/cuFFT vs CPU sum order)
SERVE_ATOL_REL = 1e-4  # ... atol as a fraction of max |CPU output|
# kernel vs plain, as a fraction of the plain output's max |value|:
DGRID_TOL = 1e-5  # same arithmetic, rounding order of the channel sum only
DIMG_TOL = 1e-5  # float atomics add the taps in an order that varies by run
SSIM_LOSS_ATOL = 1e-5  # window sums in another order than cuDNN's convs
SSIM_GRAD_TOL = 1e-4  # ... and the variance terms cancel, amplifying it
# card vs CPU through autograd (warp and SSIM alone), as a fraction of the
# max |grad| (cuDNN-free; the d_img atomics reorder sums)
GRAD_TOL = 2e-3
# a whole train step on the card against the same step in f64 on the
# CPU, as a fraction of each net's largest gradient. f32 determines these
# gradients only to a few percent at this configuration, on any device:
# the sensitivity net's output is normalised to unit magnitude (one coil),
# whose backward cancels its radial part and divides by |x|. The CPU's own
# f32 step lands up to 4.9e-2 (net_R) and 1.0e-2 (net_T) away from f64 in
# these runs (logged beside each check), the card's up to 4.6e-2. That the
# warp's gradient reaches net_T at all is checked by check_train.
STEP_GRAD_TOL = 1e-1
LOSS_RTOL = 1e-4
# registration losses, kernel vs plain on the card: the loss to 1e-5 (sums
# in another order than cuDNN's and cuBLAS's), the gradients as a fraction
# of the plain max |grad|
LNCC_LOSS_ATOL = 1e-5
LNCC_GRAD_TOL = 1e-4
# ... on the phantoms, whose plateaus leave near-flat windows where I_var
# and J_var are differences of near-equal sums: there f32 decides the LNCC
# gradient only to about 1e-4 of its max on any device (both routes are
# logged against float64)
LNCC_FLAT_GRAD_TOL = 2e-3
# MI kernel vs the plain version in float64 on the same f32 inputs (the
# plain version in f32 on the card sums the Gram over 102,400 pixels in
# cuBLAS and lands further from float64 than the kernel; it is logged):
# the loss to 1e-5, the statistics and gradients as a fraction of max
MI_LOSS_ATOL = 1e-5
MI_STATS_TOL = 2e-5
MI_GRAD_TOL = 5e-5
# the MI backward near the top bin (values in [0.9, 1]) against float64
# autograd of the plain forward, as a fraction of max |grad|: the bar the
# CPU test sets for the closed form (the cancelling form misses it)
MI_F64_TOL = 3e-6
# the four losses card vs CPU through the warp (loss values of order 1),
# gradients as a fraction of the CPU's max |grad|; both are also logged
# against float64 on the CPU
REG_LOSS_ATOL = 1e-5
REG_GRAD_TOL = 2e-3
REG_ITERS = 10
# 3x3 conv kernel against its plain version in float64 on the same inputs,
# as a fraction of max |out|: f32 sums of up to 9 x 576 products in a
# fixed order (bf16: one bf16 ulp, BF16_RTOL, beside it)
CONV_TOL = 1e-5
# the weight gradient (cuDNN's f32 backward-filter, TF32 off, summing
# 8 x 320 x 320 products a weight in an algorithm of its choosing) against
# float64, as a fraction of max |dW|: a check of the call, not of cuDNN
CONV_DW_TOL = 1e-3
# the 3x3 convs of the port's NormUnets: (in channels, chans), 4 pools
CONV_LADDER = {"cascade": (3, 18), "sensitivity": (2, 8)}
CONV_POOLS = 4
# small and ragged cases beside the ladder: (N, H, W, Cin, Cout). For the
# bf16 kernel's edges: Cin off its 16-channel step and off the 16-, 8- and
# 4-byte copies (2, 3, 5, 9, 18, 36, 65), many steps (576), Cout off its
# 8-channel mma tiles and its paired stores (2, 3, 7, 18, 65), planes that
# its 16x16, 8x16, 8x8 and 4x8 pixel tiles do not divide (20x20, 2x2, 6x4,
# 36x64); for the f32 kernel's two-image tiles at 40 and 20, an odd batch
# (3) whose last tile has one image
CONV_EDGES = [(2, 40, 24, 4, 8), (1, 40, 24, 18, 2), (3, 2, 2, 5, 7),
              (2, 20, 36, 9, 65), (2, 40, 24, 3, 2), (1, 10, 10, 576, 288),
              (2, 20, 20, 65, 18), (1, 6, 4, 36, 3), (2, 2, 2, 18, 2),
              (1, 6, 4, 2, 18), (1, 36, 64, 3, 8), (1, 20, 20, 576, 36),
              (3, 40, 40, 18, 576), (3, 20, 20, 40, 576)]


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
    return results


class _MemLocation(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _MemAllocationProp(ctypes.Structure):  # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _MemLocation), ("win32HandleMetaData", ctypes.c_void_p),
                ("compressionType", ctypes.c_ubyte), ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _MemAccessDesc(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("location", _MemLocation), ("flags", ctypes.c_int)]


@contextlib.contextmanager
def guarded(t):
    """A copy of the CUDA tensor `t` whose last byte is the last mapped byte
    of its range: the granule of addresses after it is reserved and never
    mapped (CUDA's virtual memory API), so a kernel that reads past the
    copy's end fails with an illegal-address error, where past a caching
    allocator block it would read a neighbour's bytes unnoticed."""
    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    u64 = ctypes.c_uint64

    def ok(res, what):
        if res != 0:
            raise RuntimeError(f"{what} failed: CUresult {res}")

    prop = _MemAllocationProp(type=1, location=_MemLocation(1, t.device.index or 0))
    gran = ctypes.c_size_t()
    ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0),
       "cuMemGetAllocationGranularity")
    nbytes = t.numel() * t.element_size()
    size = (nbytes + gran.value - 1) // gran.value * gran.value
    base, handle = u64(), u64()
    ok(cu.cuMemAddressReserve(ctypes.byref(base), ctypes.c_size_t(2 * size),
                              ctypes.c_size_t(0), u64(0), u64(0)), "cuMemAddressReserve")
    try:
        ok(cu.cuMemCreate(ctypes.byref(handle), ctypes.c_size_t(size), ctypes.byref(prop),
                          u64(0)), "cuMemCreate")
        try:
            ok(cu.cuMemMap(base, ctypes.c_size_t(size), ctypes.c_size_t(0), handle, u64(0)),
               "cuMemMap")
            try:
                access = _MemAccessDesc(location=prop.location, flags=3)  # read/write
                ok(cu.cuMemSetAccess(base, ctypes.c_size_t(size), ctypes.byref(access),
                                     ctypes.c_size_t(1)), "cuMemSetAccess")

                class Mapped:
                    __cuda_array_interface__ = {"shape": (size,), "typestr": "|u1",
                                                "data": (base.value, False), "strides": None,
                                                "version": 2}

                raw = torch.as_tensor(Mapped(), device=t.device)
                copy = raw[size - nbytes:].view(t.dtype).view(t.shape)
                copy.copy_(t)
                yield copy
            finally:
                torch.cuda.synchronize()  # no kernel may touch it once unmapped
                cu.cuMemUnmap(base, ctypes.c_size_t(size))
        finally:
            cu.cuMemRelease(handle)
    finally:
        cu.cuMemAddressFree(base, ctypes.c_size_t(2 * size))


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
    # (N, C, H, W, Ho, Wo, grid offset in floats): the serving plane with C
    # = 1 and 2 (four pixels a thread, 16-byte grid loads); augmentation's
    # 352 plane; an output plane other than the input's with an odd Wo and
    # an odd Ho Wo (a pixel at a time, a tail of 2 pixels past the end); a
    # grid only 8-byte aligned. Where N Ho Wo % 4 != 0 the image and the
    # grid are also read from copies that end at unmapped memory, and the
    # outputs must be the same bits.
    cases = [(BATCH, 1, SHAPE, SHAPE, SHAPE, SHAPE, 0),
             (BATCH, 2, SHAPE, SHAPE, SHAPE, SHAPE, 0),
             (4, 1, 352, 352, 352, 352, 0), (2, 2, 40, 52, 37, 45, 0),
             (2, 1, 40, 52, 36, 44, 2)]
    for n, c, h, w, ho, wo, shift in cases:
        img = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).to(dev)
        grid = sample_grid(rng, n, ho, wo).to(dev)
        buf = torch.empty(grid.numel() + shift, device=dev)
        buf[shift:] = grid.flatten()
        grid = buf[shift:].view(grid.shape)
        outside = float((grid.abs() > 1).float().mean())
        for mode in kgs.PADDING_MODES:
            got = kgs.grid_sample_cuda(img, grid, mode)
            want = kgs.grid_sample_plain(img, grid, mode)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= F32_ATOL:
                raise AssertionError(f"grid_sample f32 {tuple(img.shape)} -> {ho}x{wo} "
                                     f"{mode}: {err}")
            max_err = max(max_err, err)
            imgb = img.to(torch.bfloat16)
            gotb = kgs.grid_sample_cuda(imgb, grid, mode).float()
            wantb = kgs.grid_sample_plain(imgb, grid, mode).float()
            torch.cuda.synchronize()
            errb = float((gotb - wantb).abs().max())
            torch.testing.assert_close(gotb, wantb, rtol=BF16_RTOL, atol=0.0)
            if n * ho * wo % 4:
                for im, want_bits in ((img, got), (imgb, gotb)):
                    with guarded(im) as gim, guarded(grid) as ggrid:
                        edge = kgs.grid_sample_cuda(gim, ggrid, mode).float()
                    if not torch.equal(edge, want_bits.float()):
                        raise AssertionError(f"grid_sample {tuple(im.shape)} {im.dtype} "
                                             f"{mode}: inputs at unmapped memory change it")
                log(f"grid_sample {tuple(img.shape)} -> {ho}x{wo} {mode}: image and grid "
                    f"ending at unmapped memory, f32 and bf16: the same bits")
            log(f"grid_sample {tuple(img.shape)} -> {ho}x{wo} (grid +{shift}) {mode:10s}: "
                f"f32 max|kernel-plain| {err:.3g} (tol {F32_ATOL}), bf16 {errb:.3g} "
                f"(tol rtol {BF16_RTOL}); {outside:.4f} of grid coords beyond +-1")

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
    ms, times = time_all(fns, sets)
    n, c, h, w = sets[0][0].shape
    out_px = n * SHAPE * SHAPE
    nbytes = 4 * n * c * h * w + 8 * out_px + 4 * c * out_px
    flops = out_px * (18 + 7 * c)  # coordinates + weights, 4 taps per channel
    log(f"grid_sample timing [8,1,320,320] f32 zeros: {times} ms "
        f"({nbytes / 1e6:.1f} MB)")
    return entry(kgs.NAME, "grid_sample.cu", "grid_sample.py:222", max_err,
                 ms, nbytes, flops)


def bound(nbytes, flops, peak=F32_FLOPS):
    """(least ms for the work on an H100 SXM, "bytes" or "operations");
    `flops` at `peak`, or a list of (flops, peak) for work on units that
    issue side by side (the tensor cores and the FP32 pipe), where the
    slowest unit's share sets the time."""
    t_ops = (max(f / pk for f, pk in flops) if isinstance(flops, list)
             else flops / peak)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def entry(name, source, replaces, max_err, ms, nbytes, flops, peak=F32_FLOPS):
    """One kernel's line of the `kernels` JSON (without the launches)."""
    bound_ms, bound_by = bound(nbytes, flops, peak)
    return {
        "name": name,
        "route": "cuda",
        "source": f"spatialalignmentnetwork_tpu_torch/csrc/{source}",
        "replaces": f"spatialalignmentnetwork_tpu/ops/pallas/{replaces}",
        "max_abs_err": max_err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ms.get("library"),
    }


def time_all(fns, sets):
    """Time each of `fns` on `sets` in two rounds of opposite order;
    returns ({name: mean ms}, {name: [ms per round]})."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(time_ms(fns[k], sets))
    return {k: sum(v) / len(v) for k, v in times.items()}, times


def rel_err(got, want):
    """max |got - want| / max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_grid_sample_bwd(rng):
    """The d_grid and d_img kernels vs their plain versions on the card;
    returns their `kernels` entries (without the launch counts)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs

    dev = torch.device("cuda")
    err = {"dgrid": 0.0, "dimg": 0.0}
    for n, c, h, w in ((TRAIN_BATCH, 1, SHAPE, SHAPE), (TRAIN_BATCH, 2, SHAPE, SHAPE),
                       (2, 1, 317, 301)):
        img = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32)).to(dev)
        grid = sample_grid(rng, n, h, w).to(dev)
        for mode in kgs.PADDING_MODES:
            got = kgs.grid_sample_bwd_dgrid_cuda(img, grid, g, mode)
            want = kgs.grid_sample_bwd_dgrid_plain(img, grid, g, mode)
            e = rel_err(got, want)
            if not e <= DGRID_TOL:
                raise AssertionError(f"d_grid [{n},{c},{h},{w}] {mode}: {e}")
            err["dgrid"] = max(err["dgrid"], float((got - want).abs().max()))
            got = kgs.grid_sample_bwd_dimg_cuda(grid, g, img.shape, mode)
            again = kgs.grid_sample_bwd_dimg_cuda(grid, g, img.shape, mode)
            want = kgs.grid_sample_bwd_dimg_plain(grid, g, img.shape, mode)
            ei = rel_err(got, want)
            if not ei <= DIMG_TOL:
                raise AssertionError(f"d_img [{n},{c},{h},{w}] {mode}: {ei}")
            err["dimg"] = max(err["dimg"], float((got - want).abs().max()))
            log(f"grid_sample bwd [{n},{c},{h},{w}] {mode:10s}: d_grid "
                f"max|kernel-plain|/max|plain| {e:.3g} (tol {DGRID_TOL}), d_img "
                f"{ei:.3g} (tol {DIMG_TOL}), d_img run to run max|diff| "
                f"{float((got - again).abs().max()):.3g}")

    # time at the train shape: the warp of |aux| [4, 1, 320, 320], zeros
    sets = []
    for _ in range(10):  # 10 x 6.6 MB of inputs > 50 MB of L2
        shape = (TRAIN_BATCH, 1, SHAPE, SHAPE)
        sets.append((
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
            sample_grid(rng, TRAIN_BATCH, SHAPE, SHAPE).to(dev),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
        ))
    aten = torch.ops.aten.grid_sampler_2d_backward
    ms_grid, t_grid = time_all({
        "plain": lambda i, gr, g: kgs.grid_sample_bwd_dgrid_plain(i, gr, g),
        "kernel": lambda i, gr, g: kgs.grid_sample_bwd_dgrid_cuda(i, gr, g),
        "library": lambda i, gr, g: aten(g, i, gr, 0, 0, False, [False, True]),
    }, sets)
    ms_img, t_img = time_all({
        "plain": lambda i, gr, g: kgs.grid_sample_bwd_dimg_plain(gr, g, i.shape),
        "kernel": lambda i, gr, g: kgs.grid_sample_bwd_dimg_cuda(gr, g, i.shape),
        "library": lambda i, gr, g: aten(g, i, gr, 0, 0, False, [True, False]),
    }, sets)
    n, c, h, w = sets[0][0].shape
    px = n * h * w
    # d_grid: image, grid and upstream gradient read, d_grid written
    b_grid = 4 * n * c * h * w + 8 * px + 4 * c * px + 8 * px
    # d_img: grid and upstream gradient read, d_img written
    b_img = 8 * px + 4 * c * px + 4 * n * c * h * w
    log(f"d_grid timing [4,1,320,320] zeros: {t_grid} ms ({b_grid / 1e6:.2f} MB)")
    log(f"d_img timing [4,1,320,320] zeros: {t_img} ms ({b_img / 1e6:.2f} MB)")
    return [
        entry(kgs.DGRID, "grid_sample.cu", "grid_sample.py:451", err["dgrid"],
              ms_grid, b_grid, px * (30 + 14 * c)),
        entry(kgs.DIMG, "grid_sample.cu", "grid_sample.py:438", err["dimg"],
              ms_img, b_img, px * (20 + 8 * c)),
    ]


def check_ssim(rng):
    """The SSIM forward and backward kernels vs their plain versions on the
    card; returns their `kernels` entries (without the launch counts)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import ssim as kssim

    dev = torch.device("cuda")
    err = {"fwd": 0.0, "bwd": 0.0}
    one = torch.ones((), device=dev)
    # the train shape, C = 2, a ragged plane, the smallest plane, the planes
    # whose forward takes the shorter tiles (kernels.fwd_rows), and more
    # tiles than the card holds forward blocks at once (each walks several)
    for shape in ((TRAIN_BATCH, 1, SHAPE, SHAPE), (TRAIN_BATCH, 2, SHAPE, SHAPE),
                  (2, 1, 317, 301), (1, 1, 7, 7), (TRAIN_BATCH, 1, SHAPE // 2, SHAPE // 2),
                  (TRAIN_BATCH, 1, SHAPE // 4, SHAPE // 4), (16, 2, SHAPE, SHAPE)):
        X = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        Y = (X + torch.from_numpy(
            0.1 * rng.standard_normal(shape).astype(np.float32)).to(dev)).contiguous()
        n, c, h, w = shape
        valid = n * c * (h - 6) * (w - 6)
        got = kssim.ssim_fwd_cuda(X, Y)
        want = kssim.ssim_fwd_plain(X, Y)
        e = abs(float(got.sum() - want.sum())) / valid  # on the loss
        if not e <= SSIM_LOSS_ATOL:
            raise AssertionError(f"ssim_fwd {shape}: loss differs by {e}")
        same_bits("ssim_fwd", shape, (got,), (kssim.ssim_fwd_cuda(X, Y),))
        err["fwd"] = max(err["fwd"], e)
        dX, dY = kssim.ssim_bwd_cuda(X, Y, one)
        wX, wY = kssim.ssim_bwd_plain(X, Y, one)
        eb = max(rel_err(dX, wX), rel_err(dY, wY))
        if not eb <= SSIM_GRAD_TOL:
            raise AssertionError(f"ssim_bwd {shape}: {eb}")
        same_bits("ssim_bwd", shape, (dX, dY), kssim.ssim_bwd_cuda(X, Y, one))
        err["bwd"] = max(err["bwd"], float((dX - wX).abs().max()),
                         float((dY - wY).abs().max()))
        log(f"ssim {list(shape)}: loss |kernel-plain| {e:.3g} (tol "
            f"{SSIM_LOSS_ATOL}), dX/dY max|kernel-plain|/max|plain| {eb:.3g} "
            f"(tol {SSIM_GRAD_TOL}); loss {1 - float(got.sum()) / valid:.6f}; "
            "forward and backward the same bits run to run")

    shape = (TRAIN_BATCH, 1, SHAPE, SHAPE)
    sets = []
    for _ in range(20):  # 20 x 3.3 MB of inputs > 50 MB of L2
        X = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        sets.append((X, (X * 0.9 + 0.05).contiguous(), one))
    ms_fwd, t_fwd = time_all({
        "plain": lambda x, y, g: kssim.ssim_fwd_plain(x, y),
        "kernel": lambda x, y, g: kssim.ssim_fwd_cuda(x, y),
    }, sets)
    ms_bwd, t_bwd = time_all({
        "plain": lambda x, y, g: kssim.ssim_bwd_plain(x, y, g),
        "kernel": lambda x, y, g: kssim.ssim_bwd_cuda(x, y, g),
    }, sets)
    px = int(np.prod(shape))
    b_fwd = 8 * px + 4 * shape[0] * shape[1]  # X, Y read; per-plane sums
    b_bwd = 16 * px + 4  # X, Y (and g) read; dX, dY written
    log(f"ssim_fwd timing {list(shape)}: {t_fwd} ms ({b_fwd / 1e6:.2f} MB); "
        f"ssim_bwd: {t_bwd} ms ({b_bwd / 1e6:.2f} MB), peak device memory of a "
        f"call {peak_mb(lambda: kssim.ssim_bwd_cuda(*sets[0])):.2f} MB; no one-call "
        "PyTorch equivalent")
    return [
        entry(kssim.FWD, "ssim.cu", "ssim.py:81", err["fwd"], ms_fwd, b_fwd,
              100 * px),
        entry(kssim.BWD, "ssim.cu", "ssim.py:204", err["bwd"], ms_bwd, b_bwd,
              200 * px),
    ]


def same_bits(name, shape, got, again):
    """Fail unless a second run of a kernel gave the same bits."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} {list(shape)}: the bits differ run to run")


def peak_mb(fn):
    """MB of device memory a call of `fn` holds at its peak beyond what was
    allocated before it (its outputs and any scratch)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / 1e6


def time_windows(rng, side):
    """The SSIM and LNCC (win 9) kernels' device ms alone at [4, 1, side,
    side], on 20 sets of X and Y = 0.9 X + 0.05 (ms_lncc_loss's planes are
    320, 160 and 80), beside their byte bounds: the forwards read X and Y
    and write a sum a plane, the backwards read X and Y and write dX and
    dY. Returns {name: ms}."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc
    from spatialalignmentnetwork_tpu_torch.kernels import ssim as kssim

    dev = torch.device("cuda")
    one = torch.ones((), device=dev)
    shape = (TRAIN_BATCH, 1, side, side)
    sets = []
    for _ in range(20):
        X = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        sets.append((X, (X * 0.9 + 0.05).contiguous(), one))
    ms, times = time_all({"ssim_fwd": lambda x, y, g: kssim.ssim_fwd_cuda(x, y),
                          "lncc_fwd": lambda x, y, g: klncc.lncc_fwd_cuda(x, y),
                          "ssim_bwd": kssim.ssim_bwd_cuda,
                          "lncc_bwd": klncc.lncc_bwd_cuda}, sets)
    px = int(np.prod(shape))
    log(f"window kernels alone {list(shape)}: {times} ms; byte bounds: forwards "
        f"{bound(8 * px + 4 * shape[0], 0)[0]:.5f} ms, backwards "
        f"{bound(16 * px + 4, 0)[0]:.5f} ms")
    return ms


def time_fwd_rows(rng, side):
    """The SSIM and LNCC (win 9) forwards' device ms at [4, 1, side, side]
    at each tile height of kernels.FWD_ROWS, beside the one that
    kernels.fwd_rows picks: the measurement behind the rule. Returns
    {(name, rows): ms}."""
    from unittest import mock

    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc
    from spatialalignmentnetwork_tpu_torch.kernels import ssim as kssim

    dev = torch.device("cuda")
    shape = (TRAIN_BATCH, 1, side, side)
    sets = []
    for _ in range(20):
        X = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        sets.append((X, (X * 0.9 + 0.05).contiguous()))

    def at(mod, fn, th):
        def run(x, y):
            with mock.patch.object(mod, "fwd_rows", lambda *a: th):
                return fn(x, y)
        return run

    fns = {}
    for th in kernels.FWD_ROWS:
        fns[("ssim_fwd", th)] = at(kssim, kssim.ssim_fwd_cuda, th)
        fns[("lncc_fwd", th)] = at(klncc, klncc.lncc_fwd_cuda, th)
    ms, _ = time_all(fns, sets)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    picked = {"ssim_fwd": kernels.fwd_rows(TRAIN_BATCH, side - 6, side - 6, sms),
              "lncc_fwd": kernels.fwd_rows(TRAIN_BATCH, side, side, sms)}
    log(f"forwards by tile rows {list(shape)}: " + ", ".join(
        f"{name} {th}: {t:.5f} ms" for (name, th), t in ms.items())
        + f"; fwd_rows picks {picked}")
    return ms


def registration_pair(rng, n, size):
    """Magnitude images [n, 1, size, size] of the target and aux phantoms,
    scaled to [0, 1], with a tissue texture (a smooth random field of 10%
    relative amplitude at an 8-pixel scale) and complex Gaussian noise of
    0.02 in the foreground, and an exactly zero background, as in masked
    MRI. (Without texture the ellipses are near-flat, the more so at the
    coarse scales of the ms losses, and there the f32 LNCC gradient is
    rounding noise on any device: I_var is a difference of near-equal
    sums.)"""
    import torch

    def magnitude(x):
        nz = 0.02 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        field = smooth_field(rng, n, size, size, coarse=size // 8)[..., :1]
        tissue = np.abs(x) * (1.0 + 0.1 * field.permute(0, 3, 1, 2).numpy())
        img = np.where(x != 0, np.abs(tissue + nz), 0.0)
        return torch.from_numpy((img / img.max()).astype(np.float32)).contiguous()

    full, aux = phantoms(rng, n, size)
    return magnitude(full), magnitude(aux)


def check_lncc(rng):
    """The LNCC forward and backward kernels vs their plain versions on the
    card; returns their `kernels` entries (without the launch counts)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc

    dev = torch.device("cuda")
    err = {"fwd": 0.0, "bwd": 0.0}
    one = torch.ones((), device=dev)
    # the path's shape and window, C = 2, a ragged plane, a plane below the
    # window, windows 5, 15 and 1, ms_lncc_loss's smaller planes, whose
    # forward takes the shorter tiles (kernels.fwd_rows), and more tiles
    # than the card holds forward blocks at once at win 15 after win 9
    # (each block walks several). At win 1 every window is flat (I_var and
    # J_var are rounding noise), so only the forward is held there.
    cases = [((TRAIN_BATCH, 1, SHAPE, SHAPE), 9, "phantoms"),
             ((TRAIN_BATCH, 1, SHAPE, SHAPE), 9, "random"),
             ((TRAIN_BATCH, 2, SHAPE, SHAPE), 9, "random"),
             ((2, 1, 317, 301), 9, "random"),
             ((1, 1, 7, 7), 9, "random"),
             ((TRAIN_BATCH, 1, SHAPE, SHAPE), 5, "random"),
             ((2, 1, 45, 37), 15, "random"),
             ((2, 1, 45, 37), 1, "random"),
             ((TRAIN_BATCH, 1, SHAPE // 2, SHAPE // 2), 9, "random"),
             ((TRAIN_BATCH, 1, SHAPE // 4, SHAPE // 4), 9, "random"),
             ((16, 2, SHAPE, SHAPE), 15, "random")]
    for shape, win, kind in cases:
        if kind == "phantoms":
            I, J = (t.to(dev) for t in registration_pair(rng, shape[0], shape[2]))
        else:
            I = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
            J = (0.6 * I + 0.4 * torch.from_numpy(
                rng.random(shape).astype(np.float32)).to(dev)).contiguous()
        px = int(np.prod(shape))
        got = klncc.lncc_fwd_cuda(I, J, win)
        want = klncc.lncc_fwd_plain(I, J, win)
        e = abs(float(got.sum() - want.sum())) / px  # on the loss
        if not e <= LNCC_LOSS_ATOL:
            raise AssertionError(f"lncc_fwd {shape} win {win} {kind}: loss differs by {e}")
        same_bits(f"lncc_fwd win {win} {kind}", shape, (got,),
                  (klncc.lncc_fwd_cuda(I, J, win),))
        err["fwd"] = max(err["fwd"], e)
        if kind == "phantoms":
            f64 = float(klncc.lncc_fwd_plain(I.double(), J.double(), win).sum())
            log(f"lncc_fwd {kind} loss against float64: kernel "
                f"{abs(float(got.sum()) - f64) / px:.3g}, plain f32 "
                f"{abs(float(want.sum()) - f64) / px:.3g}")
        if win == 1:
            log(f"lncc {list(shape)} win 1 {kind}: loss |kernel-plain| {e:.3g} (tol "
                f"{LNCC_LOSS_ATOL}); the forward the same bits run to run")
            continue
        dI, dJ = klncc.lncc_bwd_cuda(I, J, one, win)
        wI, wJ = klncc.lncc_bwd_plain(I, J, one, win)
        same_bits(f"lncc_bwd win {win} {kind}", shape, (dI, dJ),
                  klncc.lncc_bwd_cuda(I, J, one, win))
        eb = max(rel_err(dI, wI), rel_err(dJ, wJ))
        tol = LNCC_FLAT_GRAD_TOL if kind == "phantoms" else LNCC_GRAD_TOL
        if kind == "phantoms":
            fI, fJ = klncc.lncc_bwd_plain(I.double(), J.double(), one.double(), win)
            log(f"lncc_bwd {kind} against float64: kernel "
                f"{max(rel_err(dI.double(), fI), rel_err(dJ.double(), fJ)):.3g}, "
                f"plain f32 {max(rel_err(wI.double(), fI), rel_err(wJ.double(), fJ)):.3g} "
                "of max |grad|")
        if not eb <= tol:
            raise AssertionError(f"lncc_bwd {shape} win {win} {kind}: {eb}")
        err["bwd"] = max(err["bwd"], float((dI - wI).abs().max()),
                         float((dJ - wJ).abs().max()))
        log(f"lncc {list(shape)} win {win} {kind}: loss |kernel-plain| {e:.3g} "
            f"(tol {LNCC_LOSS_ATOL}), dI/dJ max|kernel-plain|/max|plain| {eb:.3g} "
            f"(tol {tol}); loss {-float(got.sum()) / px:.6f}; forward and backward "
            "the same bits run to run")

    shape = (TRAIN_BATCH, 1, SHAPE, SHAPE)
    sets = []
    for _ in range(20):  # 20 x 3.3 MB of inputs > 50 MB of L2
        I = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        sets.append((I, (I * 0.9 + 0.05).contiguous(), one))
    ms_fwd, t_fwd = time_all({
        "plain": lambda i, j, g: klncc.lncc_fwd_plain(i, j),
        "kernel": lambda i, j, g: klncc.lncc_fwd_cuda(i, j),
    }, sets)
    ms_bwd, t_bwd = time_all({
        "plain": lambda i, j, g: klncc.lncc_bwd_plain(i, j, g),
        "kernel": lambda i, j, g: klncc.lncc_bwd_cuda(i, j, g),
    }, sets)
    px = int(np.prod(shape))
    b_fwd = 8 * px + 4 * shape[0] * shape[1]  # I, J read; per-plane sums
    b_bwd = 16 * px + 4  # I, J (and g) read; dI, dJ written
    win = 9
    # operations a pixel: 3 products, 5 separable sums of (win - 1) adds
    # each way, 26 for cc and its sum; the backward adds 5 box sums of the
    # coefficient maps, 32 for the maps and 13 for dI, dJ
    f_fwd = (10 * (win - 1) + 29) * px
    f_bwd = (20 * (win - 1) + 48) * px
    log(f"lncc_fwd timing {list(shape)} win 9: {t_fwd} ms ({b_fwd / 1e6:.2f} MB); "
        f"lncc_bwd: {t_bwd} ms ({b_bwd / 1e6:.2f} MB), peak device memory of a call "
        f"{peak_mb(lambda: klncc.lncc_bwd_cuda(*sets[0])):.2f} MB; no one-call PyTorch "
        "equivalent")
    return [
        entry(klncc.FWD, "lncc.cu", "lncc.py:57", err["fwd"], ms_fwd, b_fwd, f_fwd),
        entry(klncc.BWD, "lncc.cu", "lncc.py:117", err["bwd"], ms_bwd, b_bwd, f_bwd),
    ]


def check_mi(rng):
    """The MI forward and backward kernels vs their plain versions on the
    card (the ragged bin counts 2 and 33 among the cases), the backward
    near the top bin (fed the forward kernel's statistics) against
    float64, both kernels' bits run to run and, at the ragged pixel
    counts, from inputs that end where mapped memory ends; returns their
    `kernels` entries (without the launch counts)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import mi as kmi

    dev = torch.device("cuda")
    err = {"fwd": 0.0, "bwd": 0.0}
    one = torch.ones((), device=dev)
    full = (TRAIN_BATCH, 1, SHAPE, SHAPE)
    tails = [(2, 1, 317, 301), (1, 1, 7, 7)]
    cases = [(full, (0.0, 1.0), {}, "phantoms"),
             (full, (0.0, 1.0), {}, "random"),
             ((TRAIN_BATCH, 2, SHAPE, SHAPE), (0.0, 1.0), {}, "random"),
             (tails[0], (0.0, 1.0), {}, "random"),
             (tails[1], (0.0, 1.0), {}, "random"),
             (full, (-0.3, 1.3), {}, "random"),
             (full, (-0.5, 1.5), dict(bins=32, minv=-0.5, maxv=1.5), "random"),
             (full, (0.0, 1.0), dict(bins=33), "random"),
             (tails[0], (0.0, 1.0), dict(bins=2), "random")]
    for shape, (lo, hi), kw, kind in cases:
        if kind == "phantoms":
            I, J = (t.to(dev) for t in registration_pair(rng, shape[0], shape[2]))
        else:
            I = (lo + (hi - lo) * torch.from_numpy(rng.random(shape).astype(np.float32))).to(dev)
            J = (I + 0.1 * torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)).clamp(lo, hi).contiguous()
        loss, stats = kmi.mi_fwd_cuda(I, J, **kw)
        again = kmi.mi_fwd_cuda(I, J, **kw)
        if not (torch.equal(again[0], loss) and torch.equal(again[1], stats)):
            raise AssertionError(f"mi_fwd {shape} {kw}: bits differ run to run")
        dI, dJ = kmi.mi_bwd_cuda(I, J, stats, one, **kw)
        again = kmi.mi_bwd_cuda(I, J, stats, one, **kw)
        if not (torch.equal(again[0], dI) and torch.equal(again[1], dJ)):
            raise AssertionError(f"mi_bwd {shape} {kw}: bits differ run to run")
        if shape in tails:
            # a read past I, J or the statistics fails with an illegal address
            with guarded(I) as gI, guarded(J) as gJ, guarded(stats) as gs:
                gloss, gstats = kmi.mi_fwd_cuda(gI, gJ, **kw)
                gI_, gJ_ = kmi.mi_bwd_cuda(gI, gJ, gs, one, **kw)
                torch.cuda.synchronize()
            if not (torch.equal(gloss, loss) and torch.equal(gstats, stats)
                    and torch.equal(gI_, dI) and torch.equal(gJ_, dJ)):
                raise AssertionError(f"mi {shape} {kw}: guarded inputs give other bits")
        # the plain version in float64 and, for the log, in f32
        want, wstats = kmi.mi_fwd_plain(I.double(), J.double(), **kw)
        wI, wJ = kmi.mi_bwd_plain(I.double(), J.double(), wstats, one.double(), **kw)
        e = abs(float(loss.double() - want))
        es = rel_err(stats.double(), wstats)
        eb = max(rel_err(dI.double(), wI), rel_err(dJ.double(), wJ))
        ploss, pstats = kmi.mi_fwd_plain(I, J, **kw)
        pI, pJ = kmi.mi_bwd_plain(I, J, pstats, one, **kw)
        log(f"mi {list(shape)} values [{lo}, {hi}] {kw or 'bins 64'} {kind}, "
            f"against the plain version in float64: kernel loss {e:.3g} (tol "
            f"{MI_LOSS_ATOL}), stats {es:.3g} (tol {MI_STATS_TOL}), dI/dJ {eb:.3g} "
            f"(tol {MI_GRAD_TOL}) of max; plain f32 loss "
            f"{abs(float(ploss.double() - want)):.3g}, stats "
            f"{rel_err(pstats.double(), wstats):.3g}, dI/dJ "
            f"{max(rel_err(pI.double(), wI), rel_err(pJ.double(), wJ)):.3g}; "
            f"loss {float(loss):.6f}; loss, stats and dI/dJ the same bits run to run"
            + (", and from guarded inputs" if shape in tails else ""))
        if not (e <= MI_LOSS_ATOL and es <= MI_STATS_TOL and eb <= MI_GRAD_TOL):
            raise AssertionError(f"mi {shape} {kw} {kind}: loss {e}, stats {es}, "
                                 f"grads {eb}")
        err["fwd"] = max(err["fwd"], e)
        err["bwd"] = max(err["bwd"], float((dI.double() - wI).abs().max()),
                         float((dJ.double() - wJ).abs().max()))

    # near the top bin the pixel gradient must subtract before it reduces
    I = (0.9 + 0.1 * torch.from_numpy(rng.random(full).astype(np.float32))).to(dev)
    J = (I + 0.01 * torch.from_numpy(
        rng.standard_normal(full).astype(np.float32)).to(dev)).clamp(0.9, 1.0).contiguous()
    stats = kmi.mi_fwd_cuda(I, J)[1]
    dI, dJ = kmi.mi_bwd_cuda(I, J, stats, one)
    pI, pJ = kmi.mi_bwd_plain(I, J, kmi.mi_fwd_plain(I, J)[1], one)
    I64 = I.double().requires_grad_()
    J64 = J.double().requires_grad_()
    loss64, stats64 = kmi.mi_fwd_plain(I64, J64)
    loss64.backward()
    e64 = max(rel_err(dI.double(), I64.grad), rel_err(dJ.double(), J64.grad))
    p64 = max(rel_err(pI.double(), I64.grad), rel_err(pJ.double(), J64.grad))
    # the backward kernel alone, fed float64's statistics rounded to f32:
    # how much of e64 the forward's statistics bring
    bI, bJ = kmi.mi_bwd_cuda(I, J, stats64.detach().float(), one)
    b64 = max(rel_err(bI.double(), I64.grad), rel_err(bJ.double(), J64.grad))
    log(f"mi_bwd near the top bin {list(full)}: kernel vs float64 {e64:.3g}, plain "
        f"f32 vs float64 {p64:.3g} of max |grad| (tol {MI_F64_TOL}); the forward "
        f"kernel's statistics {rel_err(stats.double(), stats64.detach()):.3g} of max "
        f"from float64's, the backward kernel fed float64's {b64:.3g}")
    if not e64 <= MI_F64_TOL:
        raise AssertionError(f"mi_bwd near the top bin: {e64} of max |grad| from f64")

    (ms_fwd, b_fwd, f_fwd), (ms_bwd, b_bwd, f_bwd) = time_mi(rng, full)
    return [
        entry(kmi.FWD, "mi.cu", "mi.py:106", err["fwd"], ms_fwd, b_fwd, f_fwd),
        entry(kmi.BWD, "mi.cu", "mi.py:246", err["bwd"], ms_bwd, b_bwd, f_bwd),
    ]


def time_mi(rng, shape, plain=True):
    """mi_fwd's and mi_bwd's device ms at `shape` (64 bins) on 20 sets of I
    and J = 0.9 I + 0.05, against their plain versions where `plain`,
    logged beside their bounds (with their products as 3xTF32 and all on
    FFMA). Returns ({name: ms}, bytes, flops) for each, the flops in
    `bound`'s list form."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import mi as kmi

    dev = torch.device("cuda")
    one = torch.ones((), device=dev)
    sets = []
    for _ in range(20):  # at [4,1,320,320], 20 x 3.3 MB of inputs > 50 MB of L2
        I = torch.from_numpy(rng.random(shape).astype(np.float32)).to(dev)
        J = (I * 0.9 + 0.05).contiguous()
        sets.append((I, J, kmi.mi_fwd_cuda(I, J)[1], one))
    fwd = {"kernel": lambda i, j, s, g: kmi.mi_fwd_cuda(i, j)}
    bwd = {"kernel": lambda i, j, s, g: kmi.mi_bwd_cuda(i, j, s, g)}
    if plain:
        fwd = {"plain": lambda i, j, s, g: kmi.mi_fwd_plain(i, j), **fwd}
        bwd = {"plain": lambda i, j, s, g: kmi.mi_bwd_plain(i, j, s, g), **bwd}
    ms_fwd, t_fwd = time_all(fwd, sets)
    ms_bwd, t_bwd = time_all(bwd, sets)
    px = int(np.prod(shape))
    B = 64
    n_stats = shape[0] * (2 * B + B * B)
    b_fwd = 8 * px + 4 * n_stats + 4  # I, J read; stats and the loss written
    b_bwd = 8 * px + 4 * n_stats + 4 + 8 * px  # I, J, stats, g read; dI, dJ written
    # operations a pixel pair, the products on the tensor cores as 3xTF32
    # (so at 495 / 3 TFLOP/s) and beside them on the FP32 pipe the rest:
    # the forward's joint Gram (2 B^2), and its responses (5 each, both
    # images) and marginals; the backward's two B x B matrix-vector
    # products (4 B^2), and its responses, each once (5 a bin, both
    # images), and per-bin terms (6 a bin, both images)
    f_fwd = [(2 * B * B * px, F32X3_FLOPS), (12 * B * px, F32_FLOPS)]
    f_bwd = [(4 * B * B * px, F32X3_FLOPS), (22 * B * px, F32_FLOPS)]

    def bounds(nbytes, flops):
        return (f"{sum(f for f, _ in flops) / 1e9:.2f} GFLOP), bound "
                f"{bound(nbytes, flops)[0]:.5f} ms with the products as 3xTF32 (the FP32 "
                f"pipe's share {bound(nbytes, flops[1:])[0]:.5f}), "
                f"{bound(nbytes, sum(f for f, _ in flops))[0]:.5f} ms all on FFMA")

    log(f"mi timing {list(shape)}: mi_fwd {t_fwd} ms ({bounds(b_fwd, f_fwd)}; mi_bwd "
        f"{t_bwd} ms ({bounds(b_bwd, f_bwd)}; no one-call PyTorch equivalent")
    return (ms_fwd, b_fwd, f_fwd), (ms_bwd, b_bwd, f_bwd)


# ------------------------------------------------------------- serving
def serving_cfg(shape=SHAPE):
    """The flagship configuration at CSModel's default widths."""
    from spatialalignmentnetwork_tpu_torch.engine.config import Config

    return Config(shape=shape, coils=1, mask="equispaced", sparsity=0.25, lr=1e-4)


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


# ------------------------------------------------------------- training
def train_cfg(shape=SHAPE):
    """The serving configuration with the reference's Rec recipe
    (commands_train_test.sh:27-38: lr 1e-4, sim 1, smooth 1000)."""
    cfg = serving_cfg(shape)
    cfg.reg = "Rec"
    cfg.weight_sim = 1.0
    cfg.weight_smooth = 1000.0
    return cfg


def grad_error(got, ref):
    """Per net: (the worst leaf's max |got - ref| / the net's max |ref|,
    that leaf's name)."""
    out = {}
    for name in ref:
        net_max = max(float(g.abs().max()) for g in ref[name].values())
        out[name] = max((float((got[name][k].double() - g).abs().max()) / net_max, k)
                        for k, g in ref[name].items())
    return out


def rec_step_f64(cfg, entries, full, aux):
    """Gradients of one Rec step on the CPU in float64 (nets, inputs and
    every op but the warp, whose plain version computes in f32), without
    the optimizer step; and the range of the sensitivity maps' magnitude
    before their unit-magnitude normalisation."""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.models.varnet import acs_mask
    from spatialalignmentnetwork_tpu_torch.ops.fft import ifft2, rss

    model = CSModel(cfg=cfg, device="cpu", seed=0)
    model.load_entries(entries)
    model.net_T.to(torch.float64)
    model.net_R.to(torch.float64)
    model._nets_mode(train=True)
    env = model._prepare(torch.from_numpy(full).to(torch.complex128),
                         torch.from_numpy(aux).to(torch.complex128), model.pruned)
    total, _ = model._regime_loss(env, "Rec")
    total.backward()
    with torch.no_grad():
        k = env["img_k_sampled"]
        acs = ifft2(k * acs_mask(k.shape[-1], model.num_low_frequencies)[None, None, None, :])
        n, c, h, w = acs.shape
        sens = rss(model.net_R.sens_net.norm_unet(acs.reshape(n * c, 1, h, w)))
    grads = {name: {k: p.grad.detach() for k, p in getattr(model, name).named_parameters()}
             for name in ("net_T", "net_R")}
    return grads, (float(sens.min()), float(sens.median()), float(sens.max()))


def check_train(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """WARMUP + TIMED Rec train steps at full width; returns the launch
    counts of that run. (The CPU tests run it at a small shape on the CPU,
    where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    model = CSModel(cfg=train_cfg(shape), device=device, seed=0)
    model.load_entries(random_entries(model, rng))
    batches = [phantoms(rng, batch, shape) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    before = [p.detach().clone() for p in model.net_T.parameters()]
    is_cuda = model.device.type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []
    kernels.reset_launches()
    for i, (full, aux) in enumerate(batches):
        if i == WARMUP_STEPS:
            if is_cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
        model.set_input(full, aux)
        model.update()
        losses.append(model._aux)
    if is_cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    steps = len(batches)
    losses = [{k: float(v) for k, v in step.items()} for step in losses]
    for i, step in enumerate(losses):
        log(f"train step {i}: {step}")
        if not all(np.isfinite(v) for v in step.values()):
            raise AssertionError(f"train step {i}: non-finite loss {step}")
    log(f"Rec train on {model.device}: batch {batch}, {shape}x{shape}, "
        f"{steps} steps ({WARMUP_STEPS} warm-up), "
        f"{secs * 1e3 / TIMED_STEPS:.2f} ms per step, "
        f"{TIMED_STEPS / secs:.3f} steps/s, {TIMED_STEPS * batch / secs:.2f} "
        f"slices/s; launches {launches}")
    if is_cuda:
        log(f"train peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        want = {"grid_sample_fwd": steps, "grid_sample_bwd_dgrid": steps,
                "ssim_fwd": steps, "ssim_bwd": steps}
        if launches != want:  # grid_sample_bwd_dimg: |aux| needs no gradient
            raise AssertionError(f"train launches {launches}, expected {want}")
    moved = [float((p.detach() - b).abs().max())
             for p, b in zip(model.net_T.parameters(), before)]
    if not min(moved) > 0:
        raise AssertionError(f"net_T parameters did not all move: {moved}")
    # the warp's gradient reaches net_T: loss_sim alone (no smoothness
    # term) must give the STN head a gradient
    model.net_T.zero_grad(set_to_none=True)
    env = model._prepare(*model._batch, model.pruned)
    _, step_losses = model._regime_loss(env, "Rec")
    step_losses["loss_sim"].backward()
    head = float(model.net_T.head.weight.grad.abs().max())
    log(f"net_T max |param change| {max(moved):.3g}; |d loss_sim / d head| "
        f"max {head:.3g}")
    if not head > 0:
        raise AssertionError("loss_sim sends no gradient into net_T")
    return launches


def check_autograd(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """ssimloss(target, warp(img, grid)) with img and grid learnable, on
    `device` and on the CPU; returns the launch counts of the device run."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.ops.grid_sample import warp
    from spatialalignmentnetwork_tpu_torch.ops.ssim import ssimloss

    size = (batch, 1, shape, shape)
    target = torch.from_numpy(rng.random(size).astype(np.float32))
    img = torch.from_numpy(rng.random(size).astype(np.float32))
    grid = sample_grid(rng, batch, shape, shape)

    def run(dev):
        i = img.to(dev).requires_grad_()
        g = grid.to(dev).requires_grad_()
        loss = ssimloss(target.to(dev), warp(i, g))
        loss.backward()
        return loss.detach().cpu(), i.grad.cpu(), g.grad.cpu()

    kernels.reset_launches()
    got = run(device)
    launches = dict(kernels.LAUNCHES)
    want = run("cpu")
    e_loss = abs(float(got[0] - want[0]))
    e_img, e_grid = rel_err(got[1], want[1]), rel_err(got[2], want[2])
    log(f"autograd {list(size)} on {device} vs cpu: loss {float(want[0]):.6f} "
        f"|diff| {e_loss:.3g}, d_img {e_img:.3g}, d_grid {e_grid:.3g} of max "
        f"|grad| (tol {GRAD_TOL}); launches {launches}")
    if not (e_loss <= SSIM_LOSS_ATOL and e_img <= GRAD_TOL and e_grid <= GRAD_TOL):
        raise AssertionError("autograd: card and CPU differ")
    if torch.device(device).type == "cuda":
        want_launches = {"grid_sample_fwd": 1, "grid_sample_bwd_dgrid": 1,
                         "grid_sample_bwd_dimg": 1, "ssim_fwd": 1, "ssim_bwd": 1}
        if launches != want_launches:
            raise AssertionError(f"autograd launches {launches}")
    return launches


def check_train_vs_cpu(rng, device="cuda", shape=SHAPE, batch=2):
    """One Rec step from the same weights on `device` and on the CPU, and
    its gradients in f64 on the CPU: step-0 losses and every parameter's
    gradient."""
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    cfg = train_cfg(shape)
    models = {dev: CSModel(cfg=cfg, device=dev, seed=0) for dev in (device, "cpu")}
    entries = random_entries(models["cpu"], rng)
    full, aux = phantoms(rng, batch, shape)
    grads, losses, secs = {}, {}, {}
    for dev, model in models.items():
        model.load_entries(entries)
        model.set_input(full, aux)
        t0 = time.perf_counter()
        model.update()
        losses[dev] = model.get_vis("scalars")["scalars"]
        secs[dev] = time.perf_counter() - t0
        grads[dev] = {
            name: {k: p.grad.detach().cpu()
                   for k, p in getattr(model, name).named_parameters()}
            for name in ("net_T", "net_R")
        }
    t0 = time.perf_counter()
    ref, sens = rec_step_f64(cfg, entries, full, aux)
    secs["cpu f64"] = time.perf_counter() - t0
    log(f"one Rec step, batch {batch}, {shape}x{shape}, {device} vs cpu: "
        f"losses {losses[device]} vs {losses['cpu']} (rtol {LOSS_RTOL}); "
        f"step seconds {secs}; |sens| before normalisation min, median, "
        f"max {sens}")
    for k, v in losses["cpu"].items():
        if not abs(losses[device][k] - v) <= LOSS_RTOL * abs(v):
            raise AssertionError(f"step-0 {k}: {losses[device][k]} vs cpu {v}")
    err = {dev: grad_error(grads[dev], ref) for dev in (device, "cpu")}
    err["card vs cpu"] = grad_error(grads[device], grads["cpu"])
    log(f"gradients, worst leaf's max |diff| / net's max |grad| (leaf): "
        f"{device} f32 vs cpu f64 {err[device]} (tol {STEP_GRAD_TOL}); cpu "
        f"f32 vs cpu f64 {err['cpu']}; {device} vs cpu f32 "
        f"{err['card vs cpu']}")
    for name, (e, leaf) in err[device].items():
        if not e <= STEP_GRAD_TOL:
            raise AssertionError(f"{name}: {device} gradients differ from "
                                 f"f64 by {e} of the net's max at {leaf}")


def check_registration(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """The four registration losses of (target, warp(aux, grid)) with aux
    and grid learnable, on `device` (cuDNN's TF32 at PyTorch's default) and
    on the CPU; returns (the launch counts of the device run, {loss: ms per
    forward + backward call on `device`: "wall" from a host loop as a
    caller sees it, and on a card "device", the same calls queued behind a
    device sleep so the host's launch overhead is hidden}). (The CPU tests
    run it at a small shape on the CPU, where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.ops.grid_sample import warp
    from spatialalignmentnetwork_tpu_torch.ops.lncc import lncc_loss, ms_lncc_loss
    from spatialalignmentnetwork_tpu_torch.ops.mi import mi_loss, ms_mi_loss

    losses = {"lncc_loss": lncc_loss, "ms_lncc_loss": ms_lncc_loss,
              "mi_loss": mi_loss, "ms_mi_loss": ms_mi_loss}
    target, aux = registration_pair(rng, batch, shape)
    grid = sample_grid(rng, batch, shape, shape)
    is_cuda = torch.device(device).type == "cuda"

    def run(dev, dtype=torch.float32):
        out = {}
        t = target.to(dev, dtype)
        for name, fn in losses.items():
            # copies: on the CPU .to() returns the tensor itself, whose
            # .grad the next loss would add to
            a = aux.to(dev, dtype, copy=True).requires_grad_()
            g = grid.to(dev, copy=True).requires_grad_()
            loss = fn(t, warp(a, g))
            loss.backward()
            out[name] = [x.double().cpu() for x in (loss.detach(), a.grad, g.grad)]
        return out

    def time_loss(fn, t, x):
        def call():
            xi = x.detach().requires_grad_()
            fn(t, xi).backward()
        for _ in range(2):
            call()
        if is_cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(REG_ITERS):
            call()
        if not is_cuda:
            return {"wall": (time.perf_counter() - t0) * 1e3 / REG_ITERS}
        end.record()
        end.synchronize()
        return {"wall": start.elapsed_time(end) / REG_ITERS,
                "device": time_ms(call, [()], iters=REG_ITERS, warmup=2)}

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        kernels.reset_launches()
        got = run(device)
        launches = dict(kernels.LAUNCHES)
        with torch.no_grad():
            warped = warp(aux.to(device), grid.to(device))
        ms = {name: time_loss(fn, target.to(device), warped) for name, fn in losses.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = run("cpu")
    ref = run("cpu", torch.float64)  # the losses in float64 (the warp's grid in f32)
    log(f"registration losses [{batch},1,{shape},{shape}] on {device}: ms per "
        f"forward + backward {ms}; launches {launches}")
    for name in losses:
        e_loss = abs(float(got[name][0] - want[name][0]))
        e_img = rel_err(got[name][1], want[name][1])
        e_grid = rel_err(got[name][2], want[name][2])
        f64 = {k: (rel_err(v[name][1], ref[name][1]), rel_err(v[name][2], ref[name][2]))
               for k, v in ((device, got), ("cpu", want))}
        log(f"{name} on {device} vs cpu: loss {float(want[name][0]):.6f} |diff| "
            f"{e_loss:.3g} (tol {REG_LOSS_ATOL}), d_aux {e_img:.3g}, d_grid "
            f"{e_grid:.3g} of max |grad| (tol {REG_GRAD_TOL}); (d_aux, d_grid) against "
            f"float64 on the cpu: {f64}")
        finite = all(bool(torch.isfinite(x).all()) for x in got[name])
        if not (finite and e_loss <= REG_LOSS_ATOL and e_img <= REG_GRAD_TOL
                and e_grid <= REG_GRAD_TOL):
            raise AssertionError(f"{name}: card and CPU differ")
    if is_cuda:
        scales = 1 + 3  # the single-scale loss, then the three scales of ms
        want_launches = {k: scales for k in (
            "lncc_fwd", "lncc_bwd", "mi_fwd", "mi_bwd")}
        want_launches.update({k: len(losses) for k in (
            "grid_sample_fwd", "grid_sample_bwd_dgrid", "grid_sample_bwd_dimg")})
        if launches != want_launches:
            raise AssertionError(f"registration launches {launches}, expected "
                                 f"{want_launches}")
    return launches, ms


# ------------------------------------------------------------- 3x3 conv
def bf16_close(got, want, scale):
    """Whether a bf16 result is within one bf16 ulp (BF16_RTOL) of `want`,
    the float64 result rounded to bf16, beside the f32 bar CONV_TOL x
    `scale` for the order of the f32 sum."""
    return bool(((got - want).abs() <= CONV_TOL * scale + BF16_RTOL * want.abs()).all())


def unet_convs(in_chans, chans, pools, size):
    """Each 3x3 conv of the port's U-Net (models/unet.py) on a size x size
    input, in the order a forward runs them: [(H, Cin, Cout)]. Encoder
    levels and the bottleneck run (in -> ch, ch -> ch), a 2x2 pool after
    each level; decoder levels run on the upsampled tensor concatenated
    with its skip (2 ch -> ch, ch -> ch)."""
    convs, cin, ch, h = [], in_chans, chans, size
    for _ in range(pools):
        convs += [(h, cin, ch), (h, ch, ch)]
        cin, ch, h = ch, 2 * ch, h // 2
    convs += [(h, cin, ch), (h, ch, ch)]
    for _ in range(pools):
        ch, h = ch // 2, 2 * h
        convs += [(h, 2 * ch, ch), (h, ch, ch)]
    return convs


def conv_ladder(size):
    """[(net, H, Cin, Cout)]: each distinct 3x3 conv of the cascade and the
    sensitivity NormUnet, in the order they first run."""
    out = []
    for net, (in_chans, chans) in CONV_LADDER.items():
        for conv in unet_convs(in_chans, chans, CONV_POOLS, size):
            if (net, *conv) not in out:
                out.append((net, *conv))
    return out


def kernel_label(mangled):
    """'conv3x3_bf16_kernel<16,16,8,1,3>' from the mangled name of a
    template instance in the sources' anonymous namespace,
    'mi_bwd_pixel_kernel' from a plain kernel's."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)  # the namespace, then the kernel
    n = m and re.match(r"\d+", mangled[m.end() + int(m.group(1)):])
    if not n:
        return mangled
    start = m.end() + int(m.group(1)) + n.end()
    end = start + int(n.group())
    name = mangled[start:end]
    if mangled[end:end + 1] != "I":
        return name
    return f"{name}<{','.join(re.findall(r'Li(\d+)E', mangled[end:]))}>"


# by source, the kernels that must run on the tensor cores and the HMMA
# each must show in its SASS: the f32 conv's and the MI forward's and
# backward's 3xTF32 run m16n8k8 TF32, the bf16 conv m16n8k16 bf16
HMMA = {"conv.cu": {"conv3x3_tf32_kernel": "HMMA.1688.F32.TF32",
                    "conv3x3_bf16_kernel": "HMMA.16816.F32.BF16"},
        "mi.cu": {"mi_fwd_gram_kernel": "HMMA.1688.F32.TF32",
                  "mi_bwd_pixel_kernel": "HMMA.1688.F32.TF32"}}
# sources whose every kernel of the stem is one HMMA names: no conv kernel
# off the tensor cores
TENSOR_CORES_ONLY = {"conv.cu": "conv3x3"}
# sources held to the build check: the HMMA ones, and the window losses'
# (no HMMA required, no spill allowed)
BUILD_CHECKED = (*HMMA, "lncc.cu", "ssim.cu")


def check_build(source, lib, compiler_log):
    """A kernel library as compiled: each kernel's registers and spills
    (from nvcc's -Xptxas -v log) and its HMMA instructions (cuobjdump
    -sass), of the type HMMA[source] requires where it names the kernel.
    Fails unless every kernel HMMA[source] names has instances and each
    runs its HMMA, no kernel of the source spills, and (TENSOR_CORES_ONLY)
    no conv kernel is outside HMMA's. Returns {kernel:
    {registers, spill bytes, hmma}}."""
    import os
    import re

    from spatialalignmentnetwork_tpu_torch import kernels

    required = HMMA.get(source, {})
    info, fn = {}, None
    for ln in compiler_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            info.setdefault(fn, {})["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            info.setdefault(fn, {})["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    fn, hmma = None, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            info.setdefault(fn, {})["hmma"] = 0
            hmma = next((op for prefix, op in required.items() if prefix in fn), "HMMA")
        elif fn and hmma in ln:
            info[fn]["hmma"] += 1
    out = {kernel_label(k): v for k, v in info.items()}
    kinds = {prefix: {k: v for k, v in out.items() if k.startswith(prefix)}
             for prefix in required}
    for k, v in sorted(out.items()):
        log(f"{source} {k}: {v.get('registers', 'n/a')} registers, "
            f"{v.get('spill', 'n/a')} spill bytes, {v.get('hmma')} HMMA")
    if not compiler_log:
        log(f"{source}: library reused from the build cache, no ptxas log to read")
    bad = [k for k, v in out.items() if v.get("spill", 0)]
    bad += [k for ks in kinds.values() for k, v in ks.items() if not v.get("hmma")]
    stem = TENSOR_CORES_ONLY.get(source)
    bad += [k for k in out if stem and stem in k and not any(map(k.startswith, required))]
    if not all(kinds.values()) or bad:
        raise AssertionError(f"{source}: kernels {sorted(out)}; failing (HMMA or "
                             f"spills) {sorted(bad)}")
    log(f"{source} SASS: " + ", ".join(
        f"{sum(v['hmma'] for v in ks.values())} {required[prefix]} in {len(ks)} "
        f"{prefix} instance(s)" for prefix, ks in kinds.items()))
    return out


def check_conv(rng):
    """The 3x3 conv kernel, forward and input gradient (the same kernel on
    the rotated weights), f32 and bf16, against its plain version in
    float64 on the same inputs, on every ladder conv at batch 8 and on
    CONV_EDGES; returns {dtype: max |kernel - plain|}."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(int(rng.integers(2**31)))
    cases = [(BATCH, h, h, cin, cout) for _, h, cin, cout in conv_ladder(SHAPE)]
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n, h, w, cin, cout in cases + CONV_EDGES:
        x = torch.randn((n, h, w, cin), device=dev, generator=gen)
        g = torch.randn((n, h, w, cout), device=dev, generator=gen)
        w3 = torch.randn((3, 3, cin, cout), device=dev, generator=gen) / (9 * cin) ** 0.5
        rel = {}
        for dtype in err:
            for part, a, b in (("out", x, w3), ("dx", g, kconv.rotate(w3))):
                a, b = a.to(dtype), b.to(dtype)
                got = kconv.conv3x3_cuda(a, b).double()
                want = kconv.conv3x3_plain(a.double(), b.double())
                scale = float(want.abs().max())
                if dtype == torch.bfloat16:
                    want = want.to(dtype).double()
                    ok = bf16_close(got, want, scale)
                else:
                    ok = float((got - want).abs().max()) <= CONV_TOL * scale
                rel[f"{str(dtype)[6:]} {part}"] = rel_err(got, want)
                err[dtype] = max(err[dtype], float((got - want).abs().max()))
                if not ok:
                    raise AssertionError(f"conv3x3 [{n},{h},{w},{cin}]->{cout} {dtype} "
                                         f"{part}: {rel_err(got, want)} of max")
        log(f"conv3x3 [{n},{h},{w},{cin}]->{cout}: max|kernel-plain f64|/max|plain| "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f" (tol {CONV_TOL}; bf16 one ulp beside it)")
    return err


def check_conv_ladder(rng, device="cuda", shape=SHAPE, batch=BATCH):
    """`conv3x3_s2d` forward and backward in f32, and forward in bf16, on
    every distinct conv of the ladder, held to float64; returns the launch
    counts of that run. (The CPU tests run it at a small plane on the CPU,
    where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv

    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    gen = torch.Generator(dev).manual_seed(int(rng.integers(2**31)))
    shapes = conv_ladder(shape)
    worst = {"out": 0.0, "dx": 0.0, "dW": 0.0, "bf16 out": 0.0}
    kernels.reset_launches()
    for net, h, cin, cout in shapes:
        before = kernels.LAUNCHES[kconv.NAME]
        x = torch.randn((batch, h, h, cin), device=dev, generator=gen).requires_grad_()
        w3 = (torch.randn((3, 3, cin, cout), device=dev, generator=gen)
              / (9 * cin) ** 0.5).requires_grad_()
        g = torch.randn((batch, h, h, cout), device=dev, generator=gen)
        out = kconv.conv3x3_s2d(x, w3)
        out.backward(g)
        xb, wb = x.detach().bfloat16(), w3.detach().bfloat16()
        outb = kconv.conv3x3_s2d(xb, wb)
        n_f32 = kernels.LAUNCHES[kconv.NAME] - before
        if is_cuda and n_f32 != 2:
            raise AssertionError(f"conv {net} [{batch},{h},{h},{cin}]->{cout}: {n_f32} "
                                 "f32 launches, expected 2 (forward, input gradient)")
        for t, want_shape in ((out, (batch, h, h, cout)), (outb, (batch, h, h, cout)),
                              (x.grad, x.shape), (w3.grad, w3.shape)):
            if tuple(t.shape) != tuple(want_shape) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"conv {net} [{batch},{h},{h},{cin}]->{cout}: "
                                     f"bad output {tuple(t.shape)}")
        # float64: the plain forward and its autograd
        x64 = x.detach().double().requires_grad_()
        w64 = w3.detach().double().requires_grad_()
        want = kconv.conv3x3_plain(x64, w64)
        want.backward(g.double())
        wantb = kconv.conv3x3_plain(xb.double(), wb.double())
        scale_b = float(wantb.abs().max())
        wantb = wantb.bfloat16().double()
        rel = {"out": rel_err(out.detach().double(), want.detach()),
               "dx": rel_err(x.grad.double(), x64.grad),
               "dW": rel_err(w3.grad.double(), w64.grad),
               "bf16 out": rel_err(outb.double(), wantb)}
        if not (rel["out"] <= CONV_TOL and rel["dx"] <= CONV_TOL
                and rel["dW"] <= CONV_DW_TOL and bf16_close(outb.double(), wantb, scale_b)):
            raise AssertionError(f"conv {net} [{batch},{h},{h},{cin}]->{cout} against "
                                 f"float64: {rel}")
        worst = {k: max(v, rel[k]) for k, v in worst.items()}
    launches = dict(kernels.LAUNCHES)
    log(f"conv ladder on {device}: {len(shapes)} shapes at batch {batch}, "
        f"{shape}x{shape}; worst max|diff|/max|float64| {worst} (tol {CONV_TOL}, "
        f"dW {CONV_DW_TOL}, bf16 one ulp beside it); launches {launches}")
    if is_cuda:
        want_launches = {kconv.NAME: 2 * len(shapes), kconv.NAME_BF16: len(shapes)}
        if launches != want_launches:
            raise AssertionError(f"conv ladder launches {launches}, expected "
                                 f"{want_launches}")
    return launches


def time_conv_ladder(rng, err):
    """Each ladder conv's forward at batch 8: the kernel beside cuDNN
    (`F.conv2d` on a channels-last view of the same NHWC tensor; f32 with
    TF32 off, and bf16), beside cuDNN f32 with TF32 on (information, not
    the yardstick: it rounds the inputs to 10-bit mantissas) and its bound
    (f32: 3xTF32, the FFMA bound beside it); then one NormUnet forward's
    totals for each net. Returns the `kernels` entries of the f32 and bf16
    kernel (without the launch counts), timed at [8, 320, 320, 18] -> 18."""
    import torch
    import torch.nn.functional as F

    from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv
    from spatialalignmentnetwork_tpu_torch.ops.window import f32_convs

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(int(rng.integers(2**31)))
    kinds = ((torch.float32, "f32", F32X3_FLOPS, kconv.NAME),
             (torch.bfloat16, "bf16", BF16_FLOPS, kconv.NAME_BF16))
    rows, entries = {}, []
    for net, h, cin, cout in conv_ladder(SHAPE):
        px = BATCH * h * h
        flops = 2 * px * 9 * cin * cout
        headline = (net, h, cin, cout) == ("cascade", SHAPE, 18, 18)
        row = {}
        for dtype, tag, peak, name in kinds:
            size = torch.finfo(dtype).bits // 8
            count = min(160, max(2, -(-64_000_000 // (size * px * cin))))  # > 50 MB of L2
            xs = torch.randn((count, BATCH, h, h, cin), device=dev, generator=gen).to(dtype)
            w3 = (torch.randn((3, 3, cin, cout), device=dev, generator=gen)
                  / (9 * cin) ** 0.5).to(dtype)
            w_cl = w3.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

            def cudnn(x):
                return F.conv2d(x.permute(0, 3, 1, 2), w_cl, padding=1)

            def cudnn_tf32(x):  # inside f32_convs: TF32 off again after
                torch.backends.cudnn.allow_tf32 = True
                try:
                    return cudnn(x)
                finally:
                    torch.backends.cudnn.allow_tf32 = False

            fns = {"kernel": lambda x: kconv.conv3x3_cuda(x, w3), "library": cudnn}
            if dtype == torch.float32:
                fns["tf32"] = cudnn_tf32
            if headline:
                fns["plain"] = lambda x: kconv.conv3x3_plain(x, w3)
            with f32_convs():
                ms, _ = time_all(fns, [(x,) for x in xs])
            del xs
            nbytes = size * (px * cin + 9 * cin * cout + px * cout)
            row[tag] = (ms, *bound(nbytes, flops, peak), bound(nbytes, flops)[0])
            if headline:
                entries.append(entry(name, "conv.cu", "conv.py:117", err[dtype], ms,
                                     nbytes, flops, peak))
        rows[(net, h, cin, cout)] = row
        log(f"conv {net} [{BATCH},{h},{h},{cin}]->{cout}: " + "; ".join(
            f"{tag} kernel {ms['kernel']:.5f} ms, cuDNN {ms['library']:.5f} ms "
            f"({ms['kernel'] / ms['library']:.2f}x)"
            + (f", cuDNN TF32 {ms['tf32']:.5f} ms" if "tf32" in ms else "")
            + f", bound {b_ms:.5f} ms ({by})"
            + (f", FFMA bound {ffma_ms:.5f} ms" if tag == "f32" else "")
            + (f", plain {ms['plain']:.5f} ms" if "plain" in ms else "")
            for tag, (ms, b_ms, by, ffma_ms) in row.items()))
    for net, (in_chans, chans) in CONV_LADDER.items():
        convs = unet_convs(in_chans, chans, CONV_POOLS, SHAPE)
        total = {}
        for tag in ("f32", "bf16"):
            for key, pick in (("kernel", lambda r: r[0]["kernel"]),
                              ("cuDNN", lambda r: r[0]["library"]),
                              ("cuDNN TF32", lambda r: r[0].get("tf32")),
                              ("bound", lambda r: r[1]),
                              ("FFMA bound", lambda r: r[3])):
                if tag == "f32" or key in ("kernel", "cuDNN", "bound"):
                    total[f"{tag} {key}"] = sum(pick(rows[(net, *c)][tag]) for c in convs)
        log(f"conv ladder {net}, one NormUnet forward ({len(convs)} 3x3 convs), ms: "
            + ", ".join(f"{k} {v:.5f}" for k, v in total.items())
            + f"; kernel/cuDNN f32 {total['f32 kernel'] / total['f32 cuDNN']:.2f}x, "
            f"bf16 {total['bf16 kernel'] / total['bf16 cuDNN']:.2f}x")
    return entries


def conv_phases():
    """The conv's phases alone (its build and SASS checks, the kernel held
    to float64, the ladder and its times), for work on the conv kernel; the
    whole run is `main`. Returns the process's exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}")
    check_build("conv.cu", *build_kernels(["conv.cu"])["conv.cu"])
    rng = np.random.default_rng(0)
    conv_err = check_conv(rng)
    check_conv_ladder(rng)
    time_conv_ladder(rng, conv_err)
    return 0


# the MI entry points' launches, in order: the forward's four, the
# backward's two
MI_LAUNCHES = ("mi_fwd_gram_kernel", "mi_fwd_reduce_kernel", "mi_fwd_entropy_kernel",
               "mi_mean_kernel", "mi_bwd_coef_kernel", "mi_bwd_pixel_kernel")


def profile_mi(iters=10):
    """Device us a launch of each MI kernel (torch.profiler), over `iters`
    calls of the forward and the backward at [4,1,320,320]: how each entry
    point's time splits over its launches. Fails if a launch of
    MI_LAUNCHES is missing from the trace."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from spatialalignmentnetwork_tpu_torch.kernels import mi as kmi

    rng = np.random.default_rng(0)
    I = torch.from_numpy(rng.random((TRAIN_BATCH, 1, SHAPE, SHAPE)).astype(np.float32)).cuda()
    J = (I * 0.9 + 0.05).contiguous()
    one = torch.ones((), device=I.device)
    stats = kmi.mi_fwd_cuda(I, J)[1]
    kmi.mi_bwd_cuda(I, J, stats, one)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kmi.mi_fwd_cuda(I, J)
            kmi.mi_bwd_cuda(I, J, stats, one)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"\b(mi_\w+_kernel)\(", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            out[name.group(1)] = e.device_time
    log(f"mi kernels, device us a launch over {iters} calls [4,1,320,320]: {out}")
    missing = [k for k in MI_LAUNCHES if k not in out]
    if missing:
        raise AssertionError(f"mi launches missing from the trace: {missing}")
    return out


def mi_phases():
    """The MI kernels' phases alone (the build and SASS check of mi.cu,
    the kernels against their plain versions and float64, their times and
    each launch's share),
    for work on the MI kernels; the whole run is `main`. Returns the
    process's exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    log(f"card: {nvidia_smi()}")
    check_build("mi.cu", *build_kernels(["mi.cu"])["mi.cu"])
    rng = np.random.default_rng(0)
    for e in check_mi(rng):
        log(json.dumps(e))
    for side in (SHAPE // 2, SHAPE // 4):  # ms_mi_loss's smaller levels
        time_mi(rng, (TRAIN_BATCH, 1, side, side), plain=False)
    profile_mi()
    return 0


# the window losses' entry points; each shows at least one launch named
# after it in the trace (the fused backwards one, a two-launch tree two)
LOSS_ENTRIES = ("ssim_fwd", "ssim_bwd", "lncc_fwd", "lncc_bwd")


def profile_losses(fused_forwards=True, iters=10):
    """Device us a launch of each SSIM and LNCC kernel and memset
    (torch.profiler), over `iters` calls of each forward and backward at
    [4,1,320,320] (LNCC at win 9), each entry point profiled alone: how
    its time splits over its launches, and how many it makes a call. Fails
    unless each of LOSS_ENTRIES shows a launch and, with `fused_forwards`
    (false for a tree whose forwards still take two launches), each
    forward makes one launch a call and no memset."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from spatialalignmentnetwork_tpu_torch.kernels import lncc as klncc
    from spatialalignmentnetwork_tpu_torch.kernels import ssim as kssim

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.random((TRAIN_BATCH, 1, SHAPE, SHAPE)).astype(np.float32)).cuda()
    Y = (X * 0.9 + 0.05).contiguous()
    one = torch.ones((), device=X.device)
    calls = {"ssim_fwd": lambda: kssim.ssim_fwd_cuda(X, Y),
             "ssim_bwd": lambda: kssim.ssim_bwd_cuda(X, Y, one),
             "lncc_fwd": lambda: klncc.lncc_fwd_cuda(X, Y),
             "lncc_bwd": lambda: klncc.lncc_bwd_cuda(X, Y, one)}
    out, per_call = {}, {}
    for entry, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        per_call[entry] = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = re.search(r"\b((?:ssim|lncc)_\w+_kernel)(?:<[\d, ]+>)?\(", e.key)
            key = name.group(1) if name else ("memset" if "memset" in e.key.lower() else None)
            if key:
                out[f"{entry}: {key}"] = e.device_time
                per_call[entry][key] = e.count / iters
    log(f"ssim and lncc kernels, device us a launch over {iters} calls "
        f"[4,1,320,320]: {out}; launches a call: {per_call}")
    missing = [k for k in LOSS_ENTRIES if not any(n.startswith(k) for n in per_call[k])]
    if missing:
        raise AssertionError(f"no launch in the trace for {missing}")
    if fused_forwards:
        for k in ("ssim_fwd", "lncc_fwd"):
            if sum(per_call[k].values()) != 1:
                raise AssertionError(f"{k}: {per_call[k]} a call, not one launch")
    return out


def loss_phases(fused_forwards=True):
    """The SSIM and LNCC kernels' phases alone (the build check of ssim.cu
    and lncc.cu, the kernels against their plain versions with their bits
    run to run, their times at 320², 160² and 80², the forwards' at each
    tile height, and each launch's share), for work on those kernels; the
    whole run is `main`. Run from a tree whose forwards take two launches
    with `fused_forwards=False`. Returns the process's exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    log(f"card: {nvidia_smi()}")
    for source, (lib, compiler_log) in build_kernels(["ssim.cu", "lncc.cu"]).items():
        check_build(source, lib, compiler_log)
    rng = np.random.default_rng(0)
    for e in (*check_ssim(rng), *check_lncc(rng)):
        log(json.dumps(e))
    for side in (SHAPE // 2, SHAPE // 4):
        time_windows(rng, side)
    if fused_forwards:
        for side in (SHAPE, SHAPE // 2, SHAPE // 4):
            time_fwd_rows(rng, side)
    profile_losses(fused_forwards)
    return 0


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
    built = build_kernels(["grid_sample.cu", "ssim.cu", "lncc.cu", "mi.cu", "conv.cu"])
    for source in BUILD_CHECKED:
        check_build(source, *built[source])
    rng = np.random.default_rng(0)
    entries = [check_grid_sample(rng), *check_grid_sample_bwd(rng), *check_ssim(rng),
               *check_lncc(rng), *check_mi(rng)]
    for side in (SHAPE // 2, SHAPE // 4):  # ms_lncc_loss's smaller levels
        time_windows(rng, side)
    conv_err = check_conv(rng)
    main_paths = [check_serving(rng), check_train(rng)]
    autograd = check_autograd(rng)
    check_train_vs_cpu(rng)
    registration = check_registration(rng)[0]
    ladder = check_conv_ladder(rng)
    entries += time_conv_ladder(rng, conv_err)
    for e in entries:
        # serving and training are the main paths; d_img runs on its own,
        # the loss kernels on the registration-loss library's entry points,
        # the conv on its own entry point's ladder
        if e["name"] == "grid_sample_bwd_dimg":
            paths = [autograd]
        elif e["name"] in ("lncc_fwd", "lncc_bwd", "mi_fwd", "mi_bwd"):
            paths = [registration]
        elif e["name"] in ("conv3x3", "conv3x3_bf16"):
            paths = [ladder]
        else:
            paths = main_paths
        e["launches"] = sum(p.get(e["name"], 0) for p in paths)
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was not launched on its path")
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
