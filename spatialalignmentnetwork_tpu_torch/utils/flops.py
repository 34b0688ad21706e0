"""Analytic forward-FLOP counts for the network zoo (the port's copy of
the JAX package's `utils/flops.py`).

`profiler.flops_of` counts what one call dispatches to PyTorch's
convolution and matmul operators (`torch.utils.flop_counter`), and only
that: it bills nothing for the FFT (cuFFT has no FLOP formula there) nor
for the hand-written kernels (the grid sample), it needs a run of the net,
and it sees a training step only as the operators that step happened to
dispatch. A benchmark's MFU needs the true totals of the architecture,
FFTs and the backward's multipliers included, from the shapes alone, so
count them analytically from the architecture definition (mirroring
models/unet.py + models/varnet.py). The counts equal the JAX package's
for the native FFT (its fft_impl="xla", cuFFT here); its matmul-DFT is a
TPU lever the port does not have.

Conventions: 1 MAC = 2 FLOPs; a complex MAC = 4 real multiplies + 4 adds
(counted as 8 FLOPs); FFT cost uses the standard 5*N*log2(N) real-FLOP
estimate per length-N transform line. Elementwise work (norms,
activations, data consistency) is excluded — it is bandwidth, not FLOPs.
"""

import math


def conv2d_flops(h, w, kh, kw, cin, cout):
    """Dense stride-1 'SAME' conv over one sample."""
    return 2 * h * w * kh * kw * cin * cout


def unet_flops(h, w, in_chans, out_chans, chans, num_pools):
    """fastMRI Unet (models/unet.py Unet): ConvBlock = 2 convs per level;
    down path, bottleneck, up path (TransposeConvBlock + post-concat
    ConvBlock), final 1x1 conv."""
    total = 0
    chs = [chans * (2 ** i) for i in range(num_pools)]
    hh, ww = h, w
    # down path
    cin = in_chans
    for c in chs:
        total += conv2d_flops(hh, ww, 3, 3, cin, c)
        total += conv2d_flops(hh, ww, 3, 3, c, c)
        cin = c
        hh, ww = hh // 2, ww // 2
    # bottleneck
    total += conv2d_flops(hh, ww, 3, 3, chs[-1], chs[-1] * 2)
    total += conv2d_flops(hh, ww, 3, 3, chs[-1] * 2, chs[-1] * 2)
    cur = chs[-1] * 2
    # up path
    for c in reversed(chs):
        hh, ww = hh * 2, ww * 2
        # ConvTranspose 2x2 stride 2: one MAC per output pixel per (cin,cout)
        total += 2 * hh * ww * cur * c
        # post-concat ConvBlock: in 2c -> c, then c -> c
        total += conv2d_flops(hh, ww, 3, 3, 2 * c, c)
        total += conv2d_flops(hh, ww, 3, 3, c, c)
        cur = c
    total += conv2d_flops(hh, ww, 1, 1, cur, out_chans)
    return total


def _pad16(n):
    return ((n - 1) | 15) + 1


def normunet_flops(h, w, chans, num_pools, in_chans=1, use_ref=False):
    """NormUnet (models/unet.py): Unet over [2*in (+1 ref)] real channels at
    the padded-to-16 resolution."""
    hp, wp = _pad16(h), _pad16(w)
    cin = 2 * in_chans + (1 if use_ref else 0)
    return unet_flops(hp, wp, cin, 2 * in_chans, chans, num_pools)


def fft2_flops(h, w, channels=1):
    """Orthonormal complex 2-D FFT of one [h, w] plane per channel: the
    native FFT (cuFFT) at the standard 5*N*log2(N) real-FLOP estimate (h
    rows of length-w transforms + w cols of length-h)."""
    per_plane = 5.0 * h * w * (math.log2(w) + math.log2(h))
    return per_plane * channels


def varnet_flops(shape, coils=1, num_cascades=8, sens_chans=8, sens_pools=4,
                 chans=18, pools=4, use_ref=True):
    """True per-slice forward FLOPs of the flagship VarNet
    (models/varnet.py; reference varnet.py:422-530)."""
    sens, casc, edge = varnet_flops_parts(
        shape, coils, num_cascades, sens_chans, sens_pools, chans, pools,
        use_ref,
    )
    return sens + casc + edge


def varnet_flops_parts(shape, coils=1, num_cascades=8, sens_chans=8,
                       sens_pools=4, chans=18, pools=4, use_ref=True):
    """(sens_model, all_cascades, edge_ffts) forward-FLOP split of
    varnet_flops. The split matters for TRAINING cost: only the cascade
    body is rematerialized (models/varnet.py, `remat`), so with net_R_remat
    its forward is dispatched twice per step while the sensitivity model
    and the edge FFT/RSS are not."""
    h = w = shape
    # SensitivityModel: masked ifft2 per coil + per-coil NormUnet + rss
    sens = (fft2_flops(h, w, coils)
            + coils * normunet_flops(h, w, sens_chans, sens_pools))
    # cascades: ifft2 + sens_reduce (complex mul: 8 flops/px/coil) +
    # NormUnet + sens_expand + fft2 per cascade
    per_cascade = (
        fft2_flops(h, w, coils) * 2
        + 2 * (8.0 * h * w * coils)
        + normunet_flops(h, w, chans, pools, use_ref=use_ref)
    )
    # final ifft2 + rss (outside the cascades)
    edge = fft2_flops(h, w, coils)
    return sens, num_cascades * per_cascade, edge


# ---------------------------------------------------------------------------
# The other four networks (training-step accounting). Each counter mirrors
# its module's layer recursion exactly; see the module docstrings for the
# reference file:line provenance. Excluded as bandwidth-not-FLOPs (same
# convention as the header): norms, activations, pools, nearest upsamples,
# the spectral-norm power iteration (2 matvecs of [out, in*9] per conv per
# STEP — ~10 MFLOP total), grid-sample warps (banded one-hot contraction,
# ~0.3 GFLOP/slice vs the ~100 GFLOP step), and the window losses.


def libunet_flops(h, w, in_chans, out_chans, layers=(32, 64, 64, 64, 64)):
    """Forward FLOPs of models/unet_lib.py LibUNet (reference
    unet.py:119-189): recursive cat-skip UNet, avg-pool + 1x1-conv down,
    nearest-up + 1x1-conv up, residual 3x3 stacks."""
    L = list(layers)
    total = 0

    def inner(depth, hh, ww, cin):
        nonlocal total
        cur = L[depth]
        hh2, ww2 = hh // 2, ww // 2
        total += conv2d_flops(hh2, ww2, 1, 1, cin, cur)       # _down 1x1
        total += 2 * conv2d_flops(hh2, ww2, 3, 3, cur, cur)   # _res(2)
        if depth < len(L) - 1:
            ch = inner(depth + 1, hh2, ww2, cur)
            total += conv2d_flops(hh2, ww2, 3, 3, ch, cur)
            total += conv2d_flops(hh2, ww2, 3, 3, cur, cur)   # _res(1)
        total += conv2d_flops(hh, ww, 1, 1, cur, cur)         # _up 1x1
        return cur + cin                                      # concat

    l0 = L[0]
    total += conv2d_flops(h, w, 3, 3, in_chans, l0)
    total += conv2d_flops(h, w, 3, 3, l0, l0)                 # _res(1)
    ch = inner(1, h, w, l0)
    total += conv2d_flops(h, w, 3, 3, ch, l0)
    total += conv2d_flops(h, w, 3, 3, l0, l0)                 # _res(1)
    total += conv2d_flops(h, w, 3, 3, l0, out_chans)          # head
    return total


def stn_flops(shape, coils=1, feat=32, layers=(32, 64, 64, 64, 64)):
    """net_T forward (models/stn.py; reference cross.py:9-38): LibUNet over
    cat(moving, fixed) + the zero-init 3x3 offset head."""
    h = w = shape
    return (libunet_flops(h, w, 2 * coils, feat, layers)
            + conv2d_flops(h, w, 3, 3, feat, 2))


def netg_flops(shape, in_chans=1, out_chans=1,
               layers=(64, 128, 256, 512, 512)):
    """net_G forward (models/gan.py NetG; reference gan.py:76-118):
    recursive spectral-norm UNet, 2x2-stride-2 conv down, bare nearest up."""
    h = w = shape
    L = list(layers)
    total = 0

    def inner(depth, hh, ww, cin):
        nonlocal total
        cur = L[depth]
        hh2, ww2 = hh // 2, ww // 2
        total += conv2d_flops(hh2, ww2, 2, 2, cin, cur)       # _down s2 conv
        total += 2 * conv2d_flops(hh2, ww2, 3, 3, cur, cur)   # _res(2)
        if depth < len(L) - 1:
            ch = inner(depth + 1, hh2, ww2, cur)
            total += conv2d_flops(hh2, ww2, 3, 3, ch, cur)
            total += conv2d_flops(hh2, ww2, 3, 3, cur, cur)   # _res(1)
        return cur + cin                                      # up + concat

    l0 = L[0]
    total += conv2d_flops(h, w, 3, 3, in_chans, l0)
    total += conv2d_flops(h, w, 3, 3, l0, l0)                 # _res(1)
    ch = inner(1, h, w, l0)
    total += conv2d_flops(h, w, 3, 3, ch, l0)
    total += conv2d_flops(h, w, 3, 3, l0, l0)                 # _res(1)
    total += conv2d_flops(h, w, 3, 3, l0, out_chans)          # head
    return total


def netd_flops(shape, in_chans=2,
               blocks=((64,) * 2, (128,) * 2, (256,) * 2, (256,) * 2,
                       (256,) * 2)):
    """net_D forward (models/gan.py NetD; reference gan.py:120-139):
    norm-free spectral-norm conv stack, avg-pool between blocks, 1-channel
    head replacing the last pool."""
    h = w = shape
    total = 0
    hh, ww, cin = h, w, in_chans
    for bi, block in enumerate(blocks):
        for ch in block:
            total += conv2d_flops(hh, ww, 3, 3, cin, ch)
            cin = ch
        if bi < len(blocks) - 1:
            hh, ww = hh // 2, ww // 2
        else:
            total += conv2d_flops(hh, ww, 3, 3, cin, 1)
    return total


# ---------------------------------------------------------------------------
# GEMM inventory (speed-of-light modeling, scripts/train_sol.py).
#
# Each generator mirrors its FLOP counter's recursion EXACTLY (the summed
# record flops equal the counter bit-for-bit), but yields one record per
# dispatched op instead of a scalar:
#
#   {kind, h, w (output spatial), kh, kw, cin, cout, stride,
#    flops (per slice), in_elems, out_elems (activation elements per slice)}
#
# kinds: 'conv'  stride-s kh x kw conv (fwd GEMM K=cin*kh*kw, N=cout)
#        'convT' 2x2-stride-2 transpose conv (fwd GEMM K=cin, N=4*cout at
#                the INPUT resolution; h/w record the output resolution)
#        'dft'   one orthonormal 2-D FFT of `cin` planes (cuFFT), billed
#                at the 5NlogN estimate
#        'ew'    elementwise complex muls billed in the counters
#                (sens expand/reduce) — traffic, no tensor-core time.


def _rec(kind, h, w, kh, kw, cin, cout, stride, flops, in_elems, out_elems):
    return {"kind": kind, "h": h, "w": w, "kh": kh, "kw": kw, "cin": cin,
            "cout": cout, "stride": stride, "flops": float(flops),
            "in_elems": float(in_elems), "out_elems": float(out_elems)}


def _conv(h, w, kh, kw, cin, cout, stride=1):
    """Stride-s SAME conv record; h/w are OUTPUT spatial dims."""
    hi, wi = h * stride, w * stride
    return _rec("conv", h, w, kh, kw, cin, cout, stride,
                conv2d_flops(h, w, kh, kw, cin, cout),
                hi * wi * cin, h * w * cout)


def unet_convs(h, w, in_chans, out_chans, chans, num_pools):
    """Inventory of unet_flops (models/unet.py Unet)."""
    recs = []
    chs = [chans * (2 ** i) for i in range(num_pools)]
    hh, ww = h, w
    cin = in_chans
    for c in chs:
        recs.append(_conv(hh, ww, 3, 3, cin, c))
        recs.append(_conv(hh, ww, 3, 3, c, c))
        cin = c
        hh, ww = hh // 2, ww // 2
    recs.append(_conv(hh, ww, 3, 3, chs[-1], chs[-1] * 2))
    recs.append(_conv(hh, ww, 3, 3, chs[-1] * 2, chs[-1] * 2))
    cur = chs[-1] * 2
    for c in reversed(chs):
        hh, ww = hh * 2, ww * 2
        recs.append(_rec("convT", hh, ww, 2, 2, cur, c, 2,
                         2 * hh * ww * cur * c,
                         (hh // 2) * (ww // 2) * cur, hh * ww * c))
        recs.append(_conv(hh, ww, 3, 3, 2 * c, c))
        recs.append(_conv(hh, ww, 3, 3, c, c))
        cur = c
    recs.append(_conv(hh, ww, 1, 1, cur, out_chans))
    return recs


def normunet_convs(h, w, chans, num_pools, in_chans=1, use_ref=False):
    hp, wp = _pad16(h), _pad16(w)
    cin = 2 * in_chans + (1 if use_ref else 0)
    return unet_convs(hp, wp, cin, 2 * in_chans, chans, num_pools)


def varnet_convs(shape, coils=1, num_cascades=8, sens_chans=8, sens_pools=4,
                 chans=18, pools=4, use_ref=True):
    """Inventory of varnet_flops split by phase: (sens, one_cascade, edge).
    A cascade's records are dispatched num_cascades times; callers
    multiply. Each FFT is one 'dft' record with the 5NlogN estimate."""
    h = w = shape

    def fft_recs():
        per = fft2_flops(h, w, coils)
        return [_rec("dft", h, w, 1, 1, 1, 1, 1, per,
                     h * w * coils * 2, h * w * coils * 2)]

    sens = fft_recs()
    for _ in range(coils):
        sens += normunet_convs(h, w, sens_chans, sens_pools)
    casc = fft_recs() + fft_recs()
    casc.append(_rec("ew", h, w, 1, 1, coils, coils, 1,
                     2 * 8.0 * h * w * coils,
                     2 * h * w * coils * 2, 2 * h * w * coils * 2))
    casc += normunet_convs(h, w, chans, pools, use_ref=use_ref)
    edge = fft_recs()
    return sens, casc, edge


def libunet_convs(h, w, in_chans, out_chans, layers=(32, 64, 64, 64, 64)):
    """Inventory of libunet_flops (models/unet_lib.py LibUNet)."""
    L = list(layers)
    recs = []

    def inner(depth, hh, ww, cin):
        cur = L[depth]
        hh2, ww2 = hh // 2, ww // 2
        recs.append(_conv(hh2, ww2, 1, 1, cin, cur))
        recs.append(_conv(hh2, ww2, 3, 3, cur, cur))
        recs.append(_conv(hh2, ww2, 3, 3, cur, cur))
        if depth < len(L) - 1:
            ch = inner(depth + 1, hh2, ww2, cur)
            recs.append(_conv(hh2, ww2, 3, 3, ch, cur))
            recs.append(_conv(hh2, ww2, 3, 3, cur, cur))
        recs.append(_conv(hh, ww, 1, 1, cur, cur))
        return cur + cin

    l0 = L[0]
    recs.append(_conv(h, w, 3, 3, in_chans, l0))
    recs.append(_conv(h, w, 3, 3, l0, l0))
    ch = inner(1, h, w, l0)
    recs.append(_conv(h, w, 3, 3, ch, l0))
    recs.append(_conv(h, w, 3, 3, l0, l0))
    recs.append(_conv(h, w, 3, 3, l0, out_chans))
    return recs


def stn_convs(shape, coils=1, feat=32, layers=(32, 64, 64, 64, 64)):
    h = w = shape
    return (libunet_convs(h, w, 2 * coils, feat, layers)
            + [_conv(h, w, 3, 3, feat, 2)])


def netg_convs(shape, in_chans=1, out_chans=1,
               layers=(64, 128, 256, 512, 512)):
    """Inventory of netg_flops (models/gan.py NetG)."""
    h = w = shape
    L = list(layers)
    recs = []

    def inner(depth, hh, ww, cin):
        cur = L[depth]
        hh2, ww2 = hh // 2, ww // 2
        recs.append(_conv(hh2, ww2, 2, 2, cin, cur, stride=2))
        recs.append(_conv(hh2, ww2, 3, 3, cur, cur))
        recs.append(_conv(hh2, ww2, 3, 3, cur, cur))
        if depth < len(L) - 1:
            ch = inner(depth + 1, hh2, ww2, cur)
            recs.append(_conv(hh2, ww2, 3, 3, ch, cur))
            recs.append(_conv(hh2, ww2, 3, 3, cur, cur))
        return cur + cin

    l0 = L[0]
    recs.append(_conv(h, w, 3, 3, in_chans, l0))
    recs.append(_conv(h, w, 3, 3, l0, l0))
    ch = inner(1, h, w, l0)
    recs.append(_conv(h, w, 3, 3, ch, l0))
    recs.append(_conv(h, w, 3, 3, l0, l0))
    recs.append(_conv(h, w, 3, 3, l0, out_chans))
    return recs


def netd_convs(shape, in_chans=2,
               blocks=((64,) * 2, (128,) * 2, (256,) * 2, (256,) * 2,
                       (256,) * 2)):
    """Inventory of netd_flops (models/gan.py NetD)."""
    h = w = shape
    recs = []
    hh, ww, cin = h, w, in_chans
    for bi, block in enumerate(blocks):
        for ch in block:
            recs.append(_conv(hh, ww, 3, 3, cin, ch))
            cin = ch
        if bi < len(blocks) - 1:
            hh, ww = hh // 2, ww // 2
        else:
            recs.append(_conv(hh, ww, 3, 3, cin, 1))
    return recs


def train_step_flops(regime, shape, coils=1, remat=False, remat_tg=False,
                     num_cascades=8, sens_chans=8, sens_pools=4, chans=18,
                     pools=4, use_ref=True,
                     stn_feat=32, stn_layers=(32, 64, 64, 64, 64),
                     g_layers=(64, 128, 256, 512, 512),
                     d_blocks=((64,) * 2, (128,) * 2, (256,) * 2,
                               (256,) * 2, (256,) * 2)):
    """Analytic PER-SLICE FLOPs of one full training step in `regime`
    (engine/csmodel.py _regime_loss + _d_phase_loss; reference
    model.py:193-263). Returns (total, per_net dict).

    Backward-pass accounting (standard conv-net multipliers):
      * a backward pass costs ~2x the forward (the dgrad chain through
        every layer + the wgrad per conv);
      * a net that gets weight grads therefore dispatches 3x its forward;
      * net_D in the G-phase (forwardD D_loss=False, model.py:171-184) is
        differentiated THROUGH but not WRT: dgrad chain only -> 2x;
      * the D-phase (model.py:234-239) runs D forward on detached fake AND
        real and takes weight grads of both -> 2 x 3x = 6x;
      * remat=True (the cfg's net_R_remat, off by default;
        models/remat.py) re-dispatches each cascade body's forward during
        the backward -> the cascade component counts 4x, else 3x. The
        sensitivity model and edge FFTs sit outside the cascades and
        always count 3x.
      * remat_tg=True (engine/csmodel.py _remat_tg, on at global batch
        >= 24) checkpoints the trained net_T and net_G forwards -> each
        counts 4x instead of 3x. net_T in regime 'None' stays 1x (no
        gradient, never rematerialized).

    Per regime:
      None:     T fwd only (stop_gradient), R trained.
      Rec:      T + R trained.
      Mixed:    T + G + R trained, D both phases.
      GAN-Only: T + G trained, D both phases, no R.

    net_G runs on two half batches per step (the forwardG synthesis/warp
    crossover, model.py:123-140) == exactly one full-batch forward.
    """
    if regime not in ("None", "Rec", "Mixed", "GAN-Only"):
        raise ValueError(f"unknown regime {regime!r}")
    t_fwd = stn_flops(shape, coils, stn_feat, stn_layers)
    g_fwd = netg_flops(shape, layers=g_layers)
    d_fwd = netd_flops(shape, blocks=d_blocks)
    sens, casc, edge = varnet_flops_parts(
        shape, coils, num_cascades, sens_chans, sens_pools, chans, pools,
        use_ref,
    )
    casc_mult = 4.0 if remat else 3.0
    r_train = 3.0 * (sens + edge) + casc_mult * casc
    tg_mult = 4.0 if remat_tg else 3.0

    per_net = {"net_T": t_fwd if regime == "None" else tg_mult * t_fwd}
    if regime in ("None", "Rec", "Mixed"):
        per_net["net_R"] = r_train
    if regime in ("Mixed", "GAN-Only"):
        per_net["net_G"] = tg_mult * g_fwd
        per_net["net_D"] = (2.0 + 6.0) * d_fwd
    return sum(per_net.values()), per_net
