#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training (the Rec step, the
reference's own Mixed protocol and mask learning) and eval paths, in f32
and under the bf16 policy with rematerialization, alone and data-parallel,
its registration-loss library and its 3x3 conv on one NVIDIA GPU and check
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
     SSIM, LNCC and grid sample libraries' ptxas logs: no spills;
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
     grid sample backwards' bits run to run on every case (an odd plane,
     a grid only 8-byte aligned, taps spread past any shared window, all
     output pixels on one source pixel at 2^61 of int64, planes 2^40
     apart, a zero plane, g with +inf, -inf and NaN), d_img against float64
     and bit for bit against the emulation of its fixed-point arithmetic
     (phases 2 and 3 for the grid sample alone, with both backwards timed
     at [4,2,320,320] and 160² too and each launch's device time:
     `python3 -c "import chip_smoke; chip_smoke.grid_phases()"`); the
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
     grid)) with both img and grid learnable, the d_img kernel's path
     outside the Mixed step;
  7. one Rec train step on the card against the same step on the CPU: the
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
     cascade's totals;
 10. the reference's Mixed recipe at full width (net_G 64..512, net_D
     64..256, weight_gan 0.1, weight_gan_sim 1), batch 4: each step draws
     phantoms at 352, runs PBSpline augmentation on the card (one shared
     rigid + B-spline grid, a reflection-mode warp a modality), crops to
     320, then set_input and update(); 2 warm-up and 3 timed steps, launch
     counts reset just before and read just after (a step: 4
     grid_sample forwards, 2 d_grid, 1 d_img, 1 SSIM forward and backward;
     MIXED_LAUNCHES, PBSPLINE_LAUNCHES), every loss finite, every net moved;
     ms per step, slices/s, peak device memory; then one GAN-Only step and
     one Mixed step at grad_accum 2, each with its launch counts;
     PBSpline augmentation at 352 on the card against the CPU from the same
     draws (the grid, and the warped images from the same grid); one Mixed
     step against the CPU as in phase 7, net_D's D-phase gradients
     included, each net within STEP_GRAD_TOL of float64 (net_R's
     sensitivity-net leaves within SENS_ILL_TOL where the draw's
     sensitivity maps come below SENS_MIN). These draw their inputs
     after every earlier phase, which keep theirs;
 11. eval at full width (phase 11 alone: `python3 -c "import sys,
     chip_smoke; sys.exit(chip_smoke.eval_phases())"`): the eval CLI's
     loop (`engine/eval.py::evaluate`: bucket padding, staging from
     pinned memory, `CSModel.test`) over phantom volumes of 20 and 16
     slices, bucket 16, with random weights for net_T, net_R and net_G
     (its spectral vectors converged), after a warm-up pass over the same
     volumes; launch counts reset just before and read just after
     (EVAL_LAUNCHES a volume: 2 grid sample forwards, 1 SSIM forward);
     volumes/s and slices/s from CUDA events, each volume alone, the peak
     device memory; the 16-slice volume again on a model built as the
     eval CLI builds it at `--matmul_precision high` (TF32 on in every
     net_R forward, off after; its PSNR beside f32's); one 4-slice volume
     (padded to 6) against the CPU,
     with the test step in float64 on the CPU beside them, and two faults
     that metric_MI's bar must catch, read on the card's images. It draws
     after every earlier phase;
 12. the train CLI at full width, batch 4 (phase 12 alone, after phase
     10's timed steps: `python3 -c "import sys, chip_smoke;
     sys.exit(chip_smoke.train_cli_phases())"`): `engine/train.py`'s
     `open_model` and `run` (the loader, PBSpline on the card, validation
     through `CSModel.test`, checkpoints) through the reference's four
     stages (commands_train_test.sh:48-65: Single-Modal and Multi-Modal
     at --reg None, GAN-Only, Proposed at --reg Mixed with --load_nets
     net_mask net_D net_G net_T), one epoch each on phantom volumes in
     memory (2 of 6 slices, train at 352, val at 320), then one `--resume
     ""` epoch of Proposed and the eval loop on its best.pt; each stage's
     best.pt and final checkpoint, its warm-started nets equal to the
     checkpoint before the first step, the resumed iteration count and
     Adam steps, every logged loss finite, launch counts reset just before
     and read just after each stage (steps x its step's and PBSpline's,
     plus val batches x EVAL_LAUNCHES); the Proposed stage's steps/s
     (host clock, loader included) beside phase 10's step time, the
     phase's seconds and peak device memory. It draws after every earlier
     phase;
 13. mask learning at full width (phase 13 alone: `python3 -c "import sys,
     chip_smoke; sys.exit(chip_smoke.mask_phases())"`): LOUPE at sparsity
     0.25 (80 of 320 lines kept), batch 4: 2 warm-up and 3 timed Rec steps
     with the mask fixed, then as many learning it from the same weights
     and batches (CUDA events, both times printed, the learned steps' peak
     device memory), one None and one Mixed step learning it; after every
     learned step the logits moved, 80 lines kept, every loss finite, the
     launch counts (REC_LAUNCHES, NONE_LAUNCHES, MIXED_LAUNCHES); one
     learned Rec step at batch 2 against the CPU and float64 as in phase
     7, net_mask's logits included, and its planted fault (the hard mask
     for the soft sample) failing the logits' bar; Taylor saliency over 3
     batches of 4 (TAYLOR_LAUNCHES a step, its ms) against float64 at
     TAYLOR_TOL, then prune(8); the train CLI's `--mask loupe --learn_mask
     --reg Rec` and `--mask taylor --prune_every 2 --prune_num 8 --reg
     None`, one epoch each on phase 12's volumes, each final checkpoint
     reloading with the live `pruned` and weight. It draws after every
     earlier phase;
 14. the precision and memory policy at full width (phase 14 alone:
     `python3 -c "import sys, chip_smoke;
     sys.exit(chip_smoke.precision_phases())"`): serving under `use_amp`
     (bf16) at batch 8 (slices/s, peak, slice 0 against the port's bf16
     on the CPU, its relative L2 within the larger of SERVE_BF16_L2 and
     BF16_OWN times the CPU's own bf16 distance from its f32); the bf16
     Rec and Mixed (PBSpline 352 -> 320) steps at batch 4 (ms, peak,
     launches) and one step of each at batch 2 against the CPU's bf16
     step (the losses within BF16_LOSS_TOL); the f32
     Rec step with net_R_remat off and on (step 0's gradients within
     REMAT_GRAD_TOL of each net's max, both ms and peaks); one bf16 Mixed
     step at batch 24 with `_remat_tg` on and off (net_T's forward and
     net_G's two rematerialized: gradients within REMAT_GRAD_TOL, the
     BatchNorm statistics and u, v within REMAT_STATS_TOL, the
     checkpointed calls and replayed vectors counted); the bf16 Mixed
     step at the JAX package's flagship batch 16 with net_R_remat off and
     on (ms and peak; out of device memory fails the phase); one bf16
     step each of None, GAN-Only at grad_accum 2 and the LOUPE learned
     Rec step; one bf16 eval volume of 16 slices beside the f32 model's
     (finite; the reconstructions' distance and PSNRs), launch counts
     reset just before and read just after each. Forward hooks hold every
     conv and norm of the nets to bf16 (f32 in the f32 runs) on the
     untimed calls. It draws after every earlier phase;
 15. data parallelism (phase 15 alone: `python3 -c "import sys,
     chip_smoke; sys.exit(chip_smoke.parallel_phases())"`): (a) the train
     CLI's `--data_parallel` spawn path (one process a card: a world of 1
     over nccl on one card) for a Rec epoch at full width, global batch 4,
     on phase 12's volumes, beside the CLI alone from the same --seed:
     every leaf of the final checkpoints at the Adam bar, the largest
     difference and both runs' ms a step printed; (b) a gloo world of 2
     processes on the one card, each fed its rows of the same global batch
     of 4: 3 Rec updates and 3 Mixed updates (PBSpline 352 -> 320, the
     same draws), against the same steps of one process on the card from
     the same weights, batches and draws: every net's parameters at the
     Adam bar, BatchNorm statistics and u, v after the first update
     within PAR_STEP1_RTOL (after the third printed beside a world of 1's
     spread: the weights then differ by Adam's noise), both ranks the same
     bits,
     each rank's launch counts those of its steps (REC_LAUNCHES;
     MIXED_LAUNCHES and PBSPLINE_LAUNCHES); (c) in that world, `evaluate`
     of phase 11's volumes on the distributed model against it alone:
     per-volume PSNR within EVAL_PSNR_ATOL (1e-3 dB), the other scalars at
     the eval bars. The gloo world's ms are a correctness run's (gloo
     stages every collective through the host), not a speed; the phase's
     seconds and peak device memory. It draws after every earlier phase;
 16. library and tooling (phase 16 alone: `python3 -c "import sys,
     chip_smoke; sys.exit(chip_smoke.export_phases())"`): (a) a full-width
     `CSModel` (non-zero STN head) exported at batch 8 with torch.export
     (`engine/export.py`) and reloaded from its bytes: the graph holds the
     custom op `san::grid_sample_fwd` once and no aten grid sampler, the
     replay matches live `reconstruct` (rtol 1e-5, atol 1e-6 x max), one
     replayed request launches grid_sample_fwd once; the export's seconds,
     the artifact's bytes, ms a request of the replay beside live's; (b)
     `examples/torch_serve.py --resume` on (a)'s model in a fresh process;
     (c) `utils/profiler.py`'s main at 320: parameter counts as on the
     CPU, counted FLOPs as `utils/flops.py`'s conv terms, and `trace()`
     around one `reconstruct` naming grid_sample_fwd_kernel; (d)
     `auto_gpu(<the first visible card>, exclusive=True)` in a subprocess
     that reconstructs on that one card, while a second subprocess's
     non-blocking `Locker.acquire` fails (the lock must be free before). Its launches join the main paths'. It draws
     after every earlier phase.

Prints one JSON `kernels` line and the nvidia-smi line before the last
line, and ends with {"ok": true, "device": {...}}. Exits non-zero, with
no result line, on any failure or when no card is available.
"""

import concurrent.futures
import contextlib
import ctypes
import json
import os
import select
import shutil
import subprocess
import sys
import time
import types

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
# the plain version's f32 scatter (float atomics on the card) against the
# kernel's fixed-point sum, within about 2^-40 of exact; per plane
DIMG_TOL = 1e-5
DIMG_F64_TOL = 1e-6  # the kernel against the plain version in float64, per plane
SSIM_LOSS_ATOL = 1e-5  # window sums in another order than cuDNN's convs
SSIM_GRAD_TOL = 1e-4  # ... and the variance terms cancel, amplifying it
# card vs CPU through autograd (warp and SSIM alone), as a fraction of the
# max |grad| (cuDNN-free; the SSIM kernels sum their windows in another
# order than the CPU, whose d_img is an f32 scatter where the card's is a
# fixed-point sum, and SSIM's variance terms cancel, amplifying it)
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
# One rule for every regime's step. Where the sensitivity maps come near 0
# before their normalisation, f32 cannot determine the sensitivity net's
# gradients to STEP_GRAD_TOL on any device: its distance from float64
# grows about as 1/min|sens| (the CPU's f32 step, on the phantoms these
# checks draw: 1.9e-2 of net_R's max at min|sens| 2.7e-3, the Rec check;
# 0.149 at 1.3e-4, the Mixed check). Below SENS_MIN the draw is called
# ill-conditioned: net_R's `sens_net.` leaves are named and logged with
# their f64 readings (the card's and the CPU's) and held to
# SENS_ILL_TOL, fixed from the recorded readings on the Mixed check's
# draw (H100 80GB HBM3, 700 W: the card 0.337, the CPU's f32 control
# 0.149); every other leaf of every net stays at STEP_GRAD_TOL.
SENS_MIN = 1e-3
SENS_ILL_TOL = 0.5
LOSS_RTOL = 1e-4
# augmentation's planes: the reference crops its training slices from
# volumes 1.1x the crop (PBSpline deforms the 352 plane, then crops 320)
AUG_SHAPE = SHAPE * 11 // 10
# an augmentation grid on the card against the CPU from the same draws:
# cos, sin and the bicubic sums in another order (coordinates within 1)
AUG_GRID_ATOL = 1e-6
# launches of each kernel a step (no other kernel runs): a Mixed update
# warps |aux| for net_R and the crossover's [aux_TR, G(aux_RT)] for
# net_G, both with the grid's gradient (d_grid twice) and the second with
# the image's, since G(aux_RT) learns (d_img once); one SSIM loss. A
# GAN-Only update runs no net_R: only the crossover's warp and no SSIM.
# A PBSpline batch warps each of its two modalities once, complex packed
# as channels, in reflection mode, without gradients.
MIXED_LAUNCHES = {"grid_sample_fwd": 2, "grid_sample_bwd_dgrid": 2,
                  "grid_sample_bwd_dimg": 1, "ssim_fwd": 1, "ssim_bwd": 1}
GAN_ONLY_LAUNCHES = {"grid_sample_fwd": 1, "grid_sample_bwd_dgrid": 1,
                     "grid_sample_bwd_dimg": 1}
PBSPLINE_LAUNCHES = {"grid_sample_fwd": 2}
# a None update warps |aux| for net_R with the grid detached (no d_grid,
# no d_img) and runs one SSIM loss
NONE_LAUNCHES = {"grid_sample_fwd": 1, "ssim_fwd": 1, "ssim_bwd": 1}
# launches of each kernel a volume of the eval step (`CSModel.test`):
# the warp of |aux| for net_R and forwardG's warp of [aux_TR, G(aux_RT)],
# and one SSIM forward, whose per-plane sums give both loss_sim and
# metric_SSIM; no backward
EVAL_LAUNCHES = {"grid_sample_fwd": 2, "ssim_fwd": 1}
# the eval phase's volumes: slices a volume and the bucket they pad to
# (20 -> 32 runs the masked step with 12 pad slices, 16 the unpadded)
EVAL_SLICES = (20, 16)
EVAL_BUCKET = 16
# card against the CPU: one volume of EVAL_CPU_SLICES slices, padded to a
# multiple of EVAL_CPU_BUCKET (4 -> 6: the masked step, two pad slices)
EVAL_CPU_SLICES = 4
EVAL_CPU_BUCKET = 3
EVAL_PSNR_ATOL = 1e-3  # dB
EVAL_RTOL = 1e-4  # SSIM, MAE, MSE and the losses
# metric_MI is a 64-bin hard histogram of the warped reference: a pixel
# whose value two runs round to either side of a bin edge moves the mean
# MI of 4 slices of 102,400 pixels by about 2.5e-6. Readings on NVIDIA
# H100 80GB HBM3, 700 W, on the draws of `eval_phases()` and of the whole
# script: the CPU's f32 step lies 5.2e-8 and 1.3e-8 from its float64 step
# (no pixel crosses), the card 2.8e-6 and 3.6e-6 from the CPU (one
# crossing each); the faults of `mi_controls` move MI by 1.7e-2 and
# 2.3e-2 (the warp one pixel off) and 1.9e-4 and 1.4e-2 (one slice binned
# half a bin off). The bar admits about 40 crossings and stays under the
# smallest fault
EVAL_MI_ATOL = 1e-4
# phase 12, the train CLI: phantom volumes a split and slices a volume
# (train slices at the augmentation plane, val slices at the crop)
CLI_VOLUMES = 2
CLI_SLICES = 6
# the reference's four stages (commands_train_test.sh:48-65): name, --reg,
# the reference protocol ("None": single-modal, zeros), the stage whose
# best.pt it warm-starts from and the nets it loads from there; then one
# more epoch of the last stage through `--resume ""`
CLI_STAGES = (
    ("Single-Modal", "None", "None", None, None),
    ("Multi-Modal", "None", "T1", "Single-Modal", ["net_mask"]),
    ("GAN-Only", "GAN-Only", "T1", "Single-Modal", ["net_mask"]),
    ("Proposed", "Mixed", "T1", "GAN-Only", ["net_mask", "net_D", "net_G", "net_T"]),
)
# a Rec update, with the mask fixed or learned: the warp of |aux| with the
# grid's gradient (|aux| needs none: no d_img) and one SSIM loss. Learning
# a LOUPE mask adds no launch to any regime: the logits' gradient reaches
# net_T's input and the grid, whose d_grid the step runs already
REC_LAUNCHES = {"grid_sample_fwd": 1, "grid_sample_bwd_dgrid": 1, "ssim_fwd": 1, "ssim_bwd": 1}
STEP_LAUNCHES = {"None": NONE_LAUNCHES, "Rec": REC_LAUNCHES, "GAN-Only": GAN_ONLY_LAUNCHES,
                 "Mixed": MIXED_LAUNCHES}
# phase 13, mask learning: LOUPE at MASK_SPARSITY keeps int(MASK_SPARSITY
# W + 0.5) lines (80 of 320)
MASK_SPARSITY = 0.25
# a Taylor step (`CSModel.taylor_step`): the eval-mode Rec forward, and the
# backward to a per-line k-space multiplier, which reaches net_T's input
# and the grid (d_grid) and the SSIM loss; no weight gradient
TAYLOR_LAUNCHES = dict(REC_LAUNCHES)
TAYLOR_BATCHES = 3
TAYLOR_PRUNE = 8
# the Taylor saliency (the mean over TAYLOR_BATCHES) on the card against
# the CPU in float64, as a fraction of its max. A line's saliency is the
# square of the loss's gradient with respect to the line's multiplier, so
# an error e of that gradient (relative to its max) is one of about 2e of
# the saliency's max: the bar is the step check's gradient bar, doubled.
# Readings on NVIDIA H100 80GB HBM3, 700 W: on `mask_phases()`'s draws the
# saliency 1.48e-2 with the LOUPE logits' gradient (through the same
# lines) at 6.49e-3 (the CPU's f32 6.65e-3); on the whole script's draws,
# ill-conditioned (min|sens| 3.7e-4 < SENS_MIN), 3.94e-2 with the logits'
# gradient at 2.87e-2 (the CPU's f32 2.46e-2)
TAYLOR_TOL = 2 * STEP_GRAD_TOL
# the train CLI's prune schedule in phase 13 (--prune_every, --prune_num)
CLI_PRUNE_EVERY = 2
# numbers one phase measures for a later one to print beside its own
MEASURED = {}
POWER_ITERS = 50  # net_G's u and v: converged to f32 within these
# parameters whose gradient a step makes exactly 0, so Adam leaves them:
# the first cascade's dc_weight (its data term k - k_ref is 0, as the
# cascades start from k_ref) and net_D's head bias (the hinge's fake and
# real terms give it +1 and -1 a score while no score is clamped)
STILL = {"net_R": {"cascades.0.dc_weight"}, "net_D": {"head.conv.bias"}}
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


def plane_err(got, want, planes):
    """max over `planes` planes of max |got - want| / max |want| over the
    finite values of `want`; fails unless both are NaN, +inf and -inf at
    the same places. A plane of zeros must come out as zeros (err inf
    otherwise)."""
    import torch

    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(got), test(want)):
            raise AssertionError(f"{test.__name__}: at other places than the reference's")
    fin = torch.isfinite(want)
    diff = (got.double() - want.double()).abs().where(fin, 0.0).reshape(planes, -1).amax(1)
    scale = want.double().abs().where(fin, 0.0).reshape(planes, -1).amax(1)
    if bool(((scale == 0) & (diff > 0)).any()):
        return float("inf")
    return float((diff / scale.clamp_min(1e-300)).max())


def grid_bwd_cases(rng):
    """(label, img, grid, g, normal) on the card for check_grid_sample_bwd;
    `normal` marks the cases whose g is standard normal, which set the
    kernels' max_abs_err."""
    import torch

    dev = torch.device("cuda")

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    cases = []
    # the train shape, C = 2, an odd plane (a pixel at a time, a masked
    # tail), augmentation's 352 plane
    for n, c, h, w in ((TRAIN_BATCH, 1, SHAPE, SHAPE), (TRAIN_BATCH, 2, SHAPE, SHAPE),
                       (2, 1, 317, 301), (TRAIN_BATCH, 1, 352, 352)):
        cases.append((f"[{n},{c},{h},{w}]", normal(n, c, h, w),
                      sample_grid(rng, n, h, w).to(dev), normal(n, c, h, w), True))
    # taps spread over the plane: no tile's box fits the shared window
    grid = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, SHAPE, SHAPE, 2)).astype(np.float32))
    cases.append(("uniform grid in [-1.5, 1.5] (global atomics)", normal(2, 1, SHAPE, SHAPE),
                  grid.to(dev), normal(2, 1, SHAPE, SHAPE), True))
    # a grid only 8-byte aligned: d_grid and d_img a pixel at a time
    grid = sample_grid(rng, 2, SHAPE, SHAPE).to(dev)
    buf = torch.empty(grid.numel() + 2, device=dev)
    buf[2:] = grid.flatten()
    cases.append(("grid +2 floats (8-byte aligned)", normal(2, 1, SHAPE, SHAPE),
                  buf[2:].view(grid.shape), normal(2, 1, SHAPE, SHAPE), True))
    # every output pixel of a 256 x 512 plane onto source pixel (2, 2) with
    # weight 1 (x = y = -1 + 1/64: ((1/64) 320 - 1) / 2 = 2 exactly), g
    # 2^100: the sum 2^17 2^100 is exact in f32, and its word is 2^61 of
    # int64's 2^63
    cases.append(("256x512 -> pixel (2, 2), g 2^100 (int64 headroom)",
                  normal(1, 1, SHAPE, SHAPE),
                  torch.full((1, 256, 512, 2), -1.0 + 1.0 / 64, device=dev),
                  torch.full((1, 1, 256, 512), 2.0**100, device=dev), False))
    g = normal(2, 2, SHAPE, SHAPE)
    g[:, 1] *= 2.0**40
    cases.append(("channel 1's g 2^40 times channel 0's", normal(2, 2, SHAPE, SHAPE),
                  sample_grid(rng, 2, SHAPE, SHAPE).to(dev), g, False))
    g = normal(2, 1, SHAPE, SHAPE)
    g[1] = 0.0
    cases.append(("image 1's g all zero", normal(2, 1, SHAPE, SHAPE),
                  sample_grid(rng, 2, SHAPE, SHAPE).to(dev), g, False))
    g = normal(2, 1, SHAPE, SHAPE)
    inf = float("inf")
    for (b, y, x), v in (((0, 10, 10), inf), ((0, 100, 200), -inf), ((1, 50, 50), float("nan")),
                         ((0, 200, 17), inf), ((0, 201, 17), -inf)):
        g[b, 0, y, x] = v
    cases.append(("g with +inf, -inf and NaN", normal(2, 1, SHAPE, SHAPE),
                  sample_grid(rng, 2, SHAPE, SHAPE).to(dev), g, False))
    return cases


def check_grid_sample_bwd(rng):
    """The d_grid and d_img kernels on the card, on every case of
    grid_bwd_cases in every padding mode: both the same bits run to run;
    d_grid against its plain version; d_img against its plain version (f32
    scatter) and in float64, plane by plane, and bit for bit against the
    emulation of its arithmetic (kgs.grid_sample_bwd_dimg_fixed), with
    non-finite values where the plain version has them; on the odd plane
    both the same bits from inputs that end at unmapped memory. Then both
    kernels timed at the train shape; returns their `kernels` entries
    (without the launch counts)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs

    err = {"dgrid": 0.0, "dimg": 0.0}
    for label, img, grid, g, normal in grid_bwd_cases(rng):
        size = tuple(img.shape)
        n, c = size[:2]
        for mode in kgs.PADDING_MODES:
            dgrid = [kgs.grid_sample_bwd_dgrid_cuda(img, grid, g, mode) for _ in range(2)]
            same_bits(f"d_grid {label} {mode}", size, dgrid[:1], dgrid[1:])
            e = plane_err(dgrid[0], kgs.grid_sample_bwd_dgrid_plain(img, grid, g, mode), n)
            if not e <= DGRID_TOL:
                raise AssertionError(f"d_grid {label} {mode}: {e}")
            dimg = [kgs.grid_sample_bwd_dimg_cuda(grid, g, size, mode) for _ in range(2)]
            same_bits(f"d_img {label} {mode}", size, dimg[:1], dimg[1:])
            plain = kgs.grid_sample_bwd_dimg_plain(grid, g, size, mode)
            ei = plane_err(dimg[0], plain, n * c)
            e64 = plane_err(dimg[0], kgs.grid_sample_bwd_dimg_plain(grid, g.double(), size, mode),
                            n * c)
            if not (ei <= DIMG_TOL and e64 <= DIMG_F64_TOL):
                raise AssertionError(f"d_img {label} {mode}: {ei} of plain, {e64} of float64")
            fixed = kgs.grid_sample_bwd_dimg_fixed(grid, g, size, mode)
            nan = torch.isnan(fixed)
            if not (torch.equal(torch.isnan(dimg[0]), nan)
                    and torch.equal(bits(dimg[0].where(~nan, 0.0)), bits(fixed.where(~nan, 0.0)))):
                raise AssertionError(f"d_img {label} {mode}: not the emulation's bits")
            if normal:
                err["dgrid"] = max(err["dgrid"], float(
                    (dgrid[0] - kgs.grid_sample_bwd_dgrid_plain(img, grid, g, mode)).abs().max()))
                err["dimg"] = max(err["dimg"], float((dimg[0] - plain).abs().max()))
            if label == "[2,1,317,301]":
                with guarded(img) as gimg, guarded(grid) as ggrid, guarded(g) as gg:
                    edge = (kgs.grid_sample_bwd_dgrid_cuda(gimg, ggrid, gg, mode),
                            kgs.grid_sample_bwd_dimg_cuda(ggrid, gg, size, mode))
                same_bits(f"d_grid, d_img {label} {mode} at unmapped memory", size,
                          edge, (dgrid[0], dimg[0]))
            log(f"grid_sample bwd {label} {mode:10s}: d_grid max|kernel-plain|/max|plain| "
                f"{e:.3g} (tol {DGRID_TOL}); d_img {ei:.3g} of plain (tol {DIMG_TOL}), "
                f"{e64:.3g} of float64 (tol {DIMG_F64_TOL}), the emulation's bits; both the "
                f"same bits run to run"
                + ("; and from inputs ending at unmapped memory"
                   if label == "[2,1,317,301]" else ""))

    ms, nbytes, flops = time_grid_bwd(rng, (TRAIN_BATCH, 1, SHAPE, SHAPE), plain=True)
    return [
        entry(kgs.DGRID, "grid_sample.cu", "grid_sample.py:451", err["dgrid"],
              ms["dgrid"], nbytes["dgrid"], flops["dgrid"]),
        entry(kgs.DIMG, "grid_sample.cu", "grid_sample.py:438", err["dimg"],
              ms["dimg"], nbytes["dimg"], flops["dimg"]),
    ]


def time_grid_bwd(rng, shape, plain=False):
    """The d_grid and d_img kernels' device ms at `shape` [N, C, H, W]
    (zeros padding, `sample_grid`, normal image and g), on sets of inputs
    larger than L2, beside aten's grid_sampler_2d_backward for the same
    gradient and, with `plain`, the plain versions; logged with their byte
    bounds. Returns ({name: {"kernel": ms, ...}}, {name: bytes}, {name:
    flops}) for name in dgrid, dimg."""
    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs

    dev = torch.device("cuda")
    n, c, h, w = shape
    px = n * h * w
    sets = []
    for _ in range(int(60e6 // (8 * n * c * h * w + 8 * px)) + 2):
        sets.append((
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
            sample_grid(rng, n, h, w).to(dev),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
        ))
    aten = torch.ops.aten.grid_sampler_2d_backward
    fns = {
        "dgrid": {"plain": lambda i, gr, g: kgs.grid_sample_bwd_dgrid_plain(i, gr, g),
                  "kernel": lambda i, gr, g: kgs.grid_sample_bwd_dgrid_cuda(i, gr, g),
                  "library": lambda i, gr, g: aten(g, i, gr, 0, 0, False, [False, True])},
        "dimg": {"plain": lambda i, gr, g: kgs.grid_sample_bwd_dimg_plain(gr, g, i.shape),
                 "kernel": lambda i, gr, g: kgs.grid_sample_bwd_dimg_cuda(gr, g, i.shape),
                 "library": lambda i, gr, g: aten(g, i, gr, 0, 0, False, [True, False])},
    }
    # d_grid: image, grid and upstream gradient read, d_grid written;
    # d_img: grid and upstream gradient read, d_img written
    nbytes = {"dgrid": 4 * n * c * h * w + 8 * px + 4 * c * px + 8 * px,
              "dimg": 8 * px + 4 * c * px + 4 * n * c * h * w}
    flops = {"dgrid": px * (30 + 14 * c), "dimg": px * (20 + 8 * c)}
    ms = {}
    for name, f in fns.items():
        if not plain:
            f.pop("plain")
        ms[name], times = time_all(f, sets)
        log(f"{name} timing {list(shape)} zeros: {times} ms ({nbytes[name] / 1e6:.2f} MB, "
            f"bound {bound(nbytes[name], flops[name])[0]:.5f} ms)")
    return ms, nbytes, flops


def profile_grid(shape, iters=10):
    """Device us a launch of every kernel and memset that the d_grid and
    the d_img wrapper each make at `shape` (torch.profiler, `iters` calls of
    each alone), and launches a call: how each entry point's time splits.
    Fails unless each shows a launch named after its kernel."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs

    rng = np.random.default_rng(0)
    n, c, h, w = shape
    img = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
    grid = sample_grid(rng, n, h, w).cuda()
    calls = {"dgrid": lambda: kgs.grid_sample_bwd_dgrid_cuda(img, grid, g),
             "dimg": lambda: kgs.grid_sample_bwd_dimg_cuda(grid, g, img.shape)}
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        # a trace now and then comes back without device events: up to
        # three tries
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    call()
                torch.cuda.synchronize()
            out[name] = {}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                m = re.search(r"\b(\w+_kernel)\b", e.key)
                key = m.group(1) if m else ("memset" if "memset" in e.key.lower() else e.key[:48])
                out[name][key] = {"us": e.device_time, "a_call": e.count / iters}
            if any(k.startswith(f"grid_sample_bwd_{name}") for k in out[name]):
                break
        else:
            raise AssertionError(f"{name}: no launch of its kernel in the trace: {out[name]}")
    log(f"grid_sample backward launches {list(shape)}, device us a launch over {iters} "
        f"calls: {out}")
    return out


def dgrid_bits(path):
    """d_grid on the inputs of grid_bwd_cases from seed 7 (its four shape
    cases in each padding mode, the other six in zeros padding): written
    to `path` where it is missing, else held bit for bit to what it holds
    (a run from another tree: the parent's). Returns the number of
    cases."""
    import os

    import torch

    from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs

    rng = np.random.default_rng(7)
    cases = grid_bwd_cases(rng)
    got = [kgs.grid_sample_bwd_dgrid_cuda(img, grid, g, mode).cpu()
           for label, img, grid, g, _ in cases for mode in kgs.PADDING_MODES
           if mode == "zeros" or label.startswith("[")]
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(got, path)
        log(f"d_grid bits: {len(got)} cases written to {path}")
        return len(got)
    want = torch.load(path)
    same_bits(f"d_grid against {path}", [len(got)], got, want)
    if len(got) != len(want):
        raise AssertionError(f"d_grid bits: {len(got)} cases, {path} holds {len(want)}")
    log(f"d_grid bits: the same bits as {path} on all {len(got)} cases")
    return len(got)


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


def bits(t):
    """The bytes of tensor `t`, so that equal means the same bits (NaNs
    and the sign of 0 included)."""
    import torch

    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def same_bits(name, shape, got, again):
    """Fail unless a second run of a kernel gave the same bits."""
    import torch

    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)):
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


def random_entries(model, rng, gan=False):
    """Checkpoint entries for net_T and net_R (and with `gan` net_G) in the
    JAX package's layout (flax names, HWIO kernels, cascades stacked),
    from a numpy seed. net_G's spectral-norm vectors are those a trained
    checkpoint holds: u and v of its power iteration run to convergence on
    each kernel, so sigma is the kernel's largest singular value."""
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
    out = {"net_T": net_t, "net_R": net_r}
    if gan:
        net_g = make(model.net_G, from_jax.snconv_entries(model.net_G), 0)
        for key in [k for k in net_g if k.endswith("SpectralConv_0/kernel")]:
            conv = key[len("params/"):-len("/kernel")]
            w = from_jax.to_torch_layout(net_g[key], "conv").astype(np.float64)
            w = w.reshape(w.shape[0], -1)
            u = rng.standard_normal(w.shape[0])
            for _ in range(POWER_ITERS):
                v = w.T @ u
                v /= np.linalg.norm(v)
                u = w @ v
                u /= np.linalg.norm(u)
            net_g[f"stats/{conv}/u"] = u.astype(np.float32)
            net_g[f"stats/{conv}/v"] = v.astype(np.float32)
        out["net_G"] = net_g
    return out


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


def mixed_cfg(shape=SHAPE, reg="Mixed", grad_accum=1):
    """The reference's own recipe (commands_train_test.sh:29-32): the Rec
    recipe with reg Mixed (the paper's method; GAN-Only pre-trains), gan
    0.1, gan_sim 1, at CSModel's default widths (net_G 64..512, net_D
    64..256)."""
    cfg = train_cfg(shape)
    cfg.reg = reg
    cfg.weight_gan = 0.1
    cfg.weight_gan_sim = 1.0
    cfg.grad_accum = grad_accum
    return cfg


def add_counts(*counts):
    """The sum of launch-count dicts, zero counts dropped."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def scaled(counts, n):
    return {k: v * n for k, v in counts.items()}


def augmented_batch(full, aux, gen, device, shape):
    """The reference's train-time input pipeline on `device`: PBSpline
    augmentation of a (target, reference) pair of aug-size planes, then
    the center crop to `shape` (engine/train.py:41-47 of the JAX
    package)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.data.augment import augment_batch, draw
    from spatialalignmentnetwork_tpu_torch.ops.crop import center_crop

    pair = [torch.as_tensor(x, device=device) for x in (full, aux)]
    out = augment_batch("PBSpline", pair, draw(gen, pair[0].shape[0], device))
    return [center_crop(x, (shape, shape)) for x in out]


def timed_steps(model, batches, prepare, warmup=WARMUP_STEPS):
    """prepare(batch) -> set_input -> update over `batches`, the first
    `warmup` untimed; returns (seconds of the timed steps, launch counts of
    all of them, losses a step). CUDA events on a card, the host clock on
    the CPU."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels

    is_cuda = model.device.type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []
    kernels.reset_launches()
    for i, batch in enumerate(batches):
        if i == warmup:
            if is_cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
        model.set_input(*prepare(batch))
        model.update()
        losses.append(model._aux)
    if is_cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [{k: float(v) for k, v in step.items()} for step in losses]
    for i, step in enumerate(losses):
        if not all(np.isfinite(v) for v in step.values()):
            raise AssertionError(f"step {i}: non-finite loss {step}")
    return secs, launches, losses


def grad_error(got, ref, leaves=None):
    """Per net: (the worst leaf's max |got - ref| / the net's max |ref|,
    that leaf's name), over the leaves `leaves(net, leaf)` keeps (all by
    default)."""
    out = {}
    for name in ref:
        net_max = max(float(g.abs().max()) for g in ref[name].values())
        errs = [(float((got[name][k].double() - g).abs().max()) / net_max, k)
                for k, g in ref[name].items() if leaves is None or leaves(name, k)]
        if errs:
            out[name] = max(errs)
    return out


def check_train(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """WARMUP + TIMED Rec train steps at full width; returns the launch
    counts of that run. (The CPU tests run it at a small shape on the CPU,
    where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    model = CSModel(cfg=train_cfg(shape), device=device, seed=0)
    model.load_entries(random_entries(model, rng))
    batches = [phantoms(rng, batch, shape) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    before = [p.detach().clone() for p in model.net_T.parameters()]
    secs, launches, losses = timed_steps(model, batches, lambda b: b)
    steps = len(batches)
    for i, step in enumerate(losses):
        log(f"train step {i}: {step}")
    log(f"Rec train on {model.device}: batch {batch}, {shape}x{shape}, "
        f"{steps} steps ({WARMUP_STEPS} warm-up), "
        f"{secs * 1e3 / TIMED_STEPS:.2f} ms per step, "
        f"{TIMED_STEPS / secs:.3f} steps/s, {TIMED_STEPS * batch / secs:.2f} "
        f"slices/s; launches {launches}")
    if model.device.type == "cuda":
        log(f"train peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        want = scaled(REC_LAUNCHES, steps)
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
    _, step_losses, _ = model._regime_loss(env, "Rec")
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


def check_mixed(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """The reference's Mixed recipe at full width: each step draws target
    and reference phantoms at the augmentation plane, runs PBSpline
    augmentation and the center crop on `device`, then set_input and
    update(); WARMUP + TIMED steps. Returns the launch counts of that run.
    (The CPU tests run it at a small shape on the CPU, where no kernel
    launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    aug = shape * 11 // 10
    model = CSModel(cfg=mixed_cfg(shape), device=device, seed=0)
    model.load_entries(random_entries(model, rng))
    nets = ("net_T", "net_G", "net_R", "net_D")
    log("Mixed model params: " + ", ".join(
        f"{n} {sum(p.numel() for p in getattr(model, n).parameters())}" for n in nets))
    before = {n: [p.detach().clone() for p in getattr(model, n).parameters()] for n in nets}
    gen = torch.Generator(device=model.device).manual_seed(0)
    batches = [phantoms(rng, batch, aug) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    secs, launches, losses = timed_steps(
        model, batches, lambda b: augmented_batch(*b, gen, model.device, shape))
    steps = len(batches)
    for i, step in enumerate(losses):
        log(f"Mixed step {i}: {step}")
    MEASURED["mixed_ms"] = secs * 1e3 / TIMED_STEPS
    log(f"Mixed train (PBSpline {aug}->{shape}) on {model.device}: batch {batch}, "
        f"{steps} steps ({WARMUP_STEPS} warm-up), "
        f"{secs * 1e3 / TIMED_STEPS:.2f} ms per step, {TIMED_STEPS / secs:.3f} "
        f"steps/s, {TIMED_STEPS * batch / secs:.2f} slices/s; launches {launches}")
    if model.device.type == "cuda":
        log(f"Mixed train peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        want = scaled(add_counts(MIXED_LAUNCHES, PBSPLINE_LAUNCHES), steps)
        if launches != want:
            raise AssertionError(f"Mixed launches {launches}, expected {want}")
    moved, still = {}, {}
    for n in nets:
        change = {k: float((p.detach() - b).abs().max())
                  for (k, p), b in zip(getattr(model, n).named_parameters(), before[n])}
        moved[n] = min(v for k, v in change.items() if k not in STILL.get(n, ()))
        still[n] = sorted(k for k, v in change.items() if v == 0)
    log(f"Mixed: least max |param change| a tensor, per net: {moved}; tensors "
        f"that did not move: {still}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"a net's parameters did not all move: {moved}")
    return launches


def check_gan_only_and_accum(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """One GAN-Only step and one Mixed step with grad_accum 2 at full width
    (phantoms at `shape`, no augmentation), each after a warm-up step;
    their launch counts and ms. Returns the launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    out = {}
    for label, cfg, want in (
            ("GAN-Only", mixed_cfg(shape, reg="GAN-Only"), GAN_ONLY_LAUNCHES),
            ("Mixed grad_accum 2", mixed_cfg(shape, grad_accum=2),
             scaled(MIXED_LAUNCHES, 2))):
        model = CSModel(cfg=cfg, device=device, seed=0)
        model.load_entries(random_entries(model, rng))
        warm, step = phantoms(rng, batch, shape), phantoms(rng, batch, shape)
        model.set_input(*warm)
        model.update()
        is_cuda = model.device.type == "cuda"
        if is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launches()
        model.set_input(*step)
        model.update()
        launches = dict(kernels.LAUNCHES)
        losses = model.get_vis("scalars")["scalars"]
        if is_cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"{label} step on {model.device}: batch {batch}, {shape}x{shape}, "
            f"{ms:.2f} ms (host clock, one step); losses {losses}; launches {launches}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{label}: non-finite loss {losses}")
        if is_cuda and launches != want:
            raise AssertionError(f"{label} launches {launches}, expected {want}")
        out[label] = launches
    return add_counts(*out.values())


MODULES = ("net_T", "net_R", "net_G", "net_D", "net_mask")


def f64_model(cfg, entries):
    """A CSModel on the CPU from `entries`, every module in float64."""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    model = CSModel(cfg=cfg, device="cpu", seed=0)
    model.load_entries(entries)
    for name in MODULES:
        getattr(model, name).to(torch.float64)
    return model


def step_grads_f64(cfg, entries, full, aux, draws=None):
    """One step's gradients of every net it steps, on the CPU in float64
    (nets, inputs and every op but the warp, whose plain version reads its
    grid in f32), learning the mask from `draws` where given; and the
    range of the sensitivity maps' magnitude before their unit-magnitude
    normalisation, on the step's input."""
    import torch

    model = f64_model(cfg, entries)
    model._batch = (torch.from_numpy(full).to(torch.complex128),
                    torch.from_numpy(aux).to(torch.complex128))
    with torch.no_grad():
        soft = (model._loupe_sample(full.shape[0], True, torch.from_numpy(draws[0]))[0]
                if draws is not None else None)
    sens = sens_range(model, *model._batch, soft)
    model.update(draws)
    return net_grads(model), sens


def sens_range(model, full, aux, soft=None):
    """(min, median, max) of the sensitivity maps' magnitude before their
    unit-magnitude normalisation, on the sampled k-space of `full` (a
    batch on the model's device; `soft`: LOUPE's soft sample, else the
    hard mask), in the nets' dtype."""
    import torch

    from spatialalignmentnetwork_tpu_torch.models.varnet import acs_mask
    from spatialalignmentnetwork_tpu_torch.ops.fft import ifft2, rss

    with torch.no_grad():
        k = model._prepare(full, aux, model.pruned, soft)["img_k_sampled"]
        acs = ifft2(k * acs_mask(k.shape[-1], model.num_low_frequencies,
                                 k.device)[None, None, None, :])
        n, c, h, w = acs.shape
        sens = rss(model.net_R.sens_net.norm_unet(acs.reshape(n * c, 1, h, w)))
    return float(sens.min()), float(sens.median()), float(sens.max())


def net_grads(model):
    """{net: {param: grad on the CPU}} of the nets the last step stepped."""
    out = {}
    for name in MODULES:
        grads = {k: p.grad for k, p in getattr(model, name).named_parameters()}
        if grads and all(g is not None for g in grads.values()):
            out[name] = {k: g.detach().cpu() for k, g in grads.items()}
    return out


def check_train_vs_cpu(rng, device="cuda", shape=SHAPE, batch=2, reg="Rec", learn_mask=False):
    """One train step of regime `reg` (the Rec recipe, or the reference's
    for Mixed and GAN-Only; with `learn_mask`, learning a LOUPE mask from
    thresholds drawn here, the same on every device) from the same
    weights on `device` and on the CPU, and its gradients in f64 on the
    CPU: step-0 losses and the gradient of every parameter of every net
    the step steps (net_D's from the D-phase, net_mask's logits), at
    STEP_GRAD_TOL; on a draw where the sensitivity maps come below
    SENS_MIN, net_R's sensitivity-net leaves at SENS_ILL_TOL. Learning the
    mask, a planted fault (the hard mask in place of the soft sample, so
    that no gradient reaches the logits) must fail the logits' bar."""
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import GRAD_NETS, CSModel
    from spatialalignmentnetwork_tpu_torch.ops import masks as masks_lib

    if learn_mask:
        cfg = mask_cfg(shape, reg)
    else:
        cfg = train_cfg(shape) if reg == "Rec" else mixed_cfg(shape, reg=reg)
    label = f"{reg} (LOUPE learned)" if learn_mask else reg
    models = {dev: CSModel(cfg=cfg, device=dev, seed=0) for dev in (device, "cpu")}
    entries = random_entries(models["cpu"], rng)
    full, aux = phantoms(rng, batch, shape)
    draws = ((rng.random((batch, shape), dtype=np.float32),
              rng.random((1, shape), dtype=np.float32)) if learn_mask else None)
    grads, losses, secs = {}, {}, {}
    for dev, model in models.items():
        model.load_entries(entries)
        model.set_input(full, aux)
        t0 = time.perf_counter()
        model.update(draws)
        losses[dev] = model.get_vis("scalars")["scalars"]
        secs[dev] = time.perf_counter() - t0
        grads[dev] = net_grads(model)
    t0 = time.perf_counter()
    ref, sens = step_grads_f64(cfg, entries, full, aux, draws)
    secs["cpu f64"] = time.perf_counter() - t0
    log(f"one {label} step, batch {batch}, {shape}x{shape}, {device} vs cpu: "
        f"losses {losses[device]} vs {losses['cpu']} (rtol {LOSS_RTOL}); "
        f"step seconds {secs}; |sens| before normalisation min, median, "
        f"max {sens}")
    stepped = set(GRAD_NETS[reg]) | ({"net_D"} if reg != "Rec" else set())
    stepped |= {"net_mask"} if learn_mask else set()
    if not set(ref) == set(grads[device]) == stepped:
        raise AssertionError(f"{reg} step gradients of {sorted(grads[device])}, "
                             f"expected {sorted(stepped)}")
    for k, v in losses["cpu"].items():
        if not abs(losses[device][k] - v) <= LOSS_RTOL * abs(v):
            raise AssertionError(f"{reg} step-0 {k}: {losses[device][k]} vs cpu {v}")
    def ill(name, leaf):  # leaves f32 cannot determine on this draw
        return sens[0] < SENS_MIN and name == "net_R" and leaf.startswith("sens_net.")

    def well(name, leaf):
        return not ill(name, leaf)

    err = {dev: grad_error(grads[dev], ref, well) for dev in (device, "cpu")}
    err["card vs cpu"] = grad_error(grads[device], grads["cpu"], well)
    log(f"{label} gradients, worst leaf's max |diff| / net's max |grad| (leaf): "
        f"{device} f32 vs cpu f64 {err[device]} (tol {STEP_GRAD_TOL}); cpu "
        f"f32 vs cpu f64 {err['cpu']}; {device} vs cpu f32 "
        f"{err['card vs cpu']}")
    ill_err = {dev: grad_error(grads[dev], ref, ill) for dev in (device, "cpu")}
    if ill_err[device]:
        named = sorted(k for k in ref["net_R"] if ill("net_R", k))
        log(f"{label} gradients of net_R's {len(named)} sensitivity-net leaves, "
            f"ill-conditioned at min|sens| {sens[0]:.3g} < {SENS_MIN} "
            f"({named[0]} ... {named[-1]}): {device} f32 vs cpu f64 "
            f"{ill_err[device]['net_R']} (tol {SENS_ILL_TOL}); cpu f32 vs cpu "
            f"f64 {ill_err['cpu']['net_R']}")
    fails = grad_failures(grads[device], ref, ill)
    if fails:
        name, e, leaf, bar = fails[0]
        raise AssertionError(f"{reg} {name}: {device} gradients differ from "
                             f"f64 by {e} of the net's max at {leaf} (bar {bar})")
    if not learn_mask:
        return
    # the planted fault: the hard mask where the soft sample belongs
    sample = masks_lib.loupe_sample
    masks_lib.loupe_sample = lambda *a, **kw: sample(*a, **{**kw, "training": False})
    try:
        faulty = CSModel(cfg=cfg, device=device, seed=0)
        faulty.load_entries(entries)
        faulty.set_input(full, aux)
        faulty.update(draws)
    finally:
        masks_lib.loupe_sample = sample
    fails = grad_failures(net_grads(faulty), ref, ill)
    log(f"{label} planted fault (the hard mask for the soft sample) on {device}: "
        f"failing nets {[(n, round(e, 4), leaf) for n, e, leaf, _ in fails]}")
    if "net_mask" not in [f[0] for f in fails]:
        raise AssertionError("the planted fault passed the logits' gradient bar")


def grad_failures(got, ref, ill):
    """The leaves of the gradients `got` outside their bar against the
    float64 `ref`: [(net, error, leaf, bar)], STEP_GRAD_TOL for each net's
    worst well-conditioned leaf, SENS_ILL_TOL for the leaves `ill` names."""
    fails = []
    for errs, bar in ((grad_error(got, ref, lambda n, k: not ill(n, k)), STEP_GRAD_TOL),
                      (grad_error(got, ref, ill), SENS_ILL_TOL)):
        fails += [(name, e, leaf, bar) for name, (e, leaf) in errs.items() if not e <= bar]
    return fails


def check_augment(rng, device="cuda", shape=AUG_SHAPE, batch=TRAIN_BATCH):
    """PBSpline augmentation of a phantom pair at the augmentation plane on
    `device`, from draws of a generator there, against the CPU from the
    same draws: the grid (AUG_GRID_ATOL), and each warped modality against
    the CPU's warp with the same grid (F32_ATOL, the grid sample's bar);
    the CPU's images from its own grid are logged beside. Returns the
    launch counts of the device run."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.data import augment as aug
    from spatialalignmentnetwork_tpu_torch.ops.grid_sample import warp

    full, aux = phantoms(rng, batch, shape)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    pair = [torch.as_tensor(x, device=dev) for x in (full, aux)]
    kernels.reset_launches()
    draws = aug.draw(gen, batch, dev)
    got = aug.augment_batch("PBSpline", pair, draws)
    launches = dict(kernels.LAUNCHES)
    grid = aug.deformation(draws, pair[0].shape)
    draws_cpu = {k: v.cpu() for k, v in draws.items()}
    grid_cpu = aug.deformation(draws_cpu, pair[0].shape)
    e_grid = float((grid.cpu() - grid_cpu).abs().max())
    pair_cpu = [torch.from_numpy(x) for x in (full, aux)]
    same_grid = [warp(x, grid.cpu(), padding_mode="reflection") for x in pair_cpu]
    own = aug.augment_batch("PBSpline", pair_cpu, draws_cpu)
    e_img = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, same_grid))
    e_own = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, own))
    log(f"PBSpline augmentation [{batch},1,{shape},{shape}] x 2 on {device} vs cpu: "
        f"grid max|diff| {e_grid:.3g} (tol {AUG_GRID_ATOL}), images max|diff| "
        f"{e_img:.3g} from the same grid (tol {F32_ATOL}), {e_own:.3g} from the "
        f"cpu's own grid; launches {launches}")
    if not (e_grid <= AUG_GRID_ATOL and e_img <= F32_ATOL):
        raise AssertionError("augmentation: card and CPU differ")
    if dev.type == "cuda" and launches != PBSPLINE_LAUNCHES:
        raise AssertionError(f"augmentation launches {launches}, expected "
                             f"{PBSPLINE_LAUNCHES}")
    return launches


# ------------------------------------------------------------- eval
def eval_volume(rng, slices, shape):
    """One volume as the eval loop reads it: `slices` slices [target, aux],
    each a complex [1, H, W] phantom."""
    full, aux = phantoms(rng, slices, shape)
    return [[full[i], aux[i]] for i in range(slices)]


def eval_f64(cfg, entries, volume):
    """The unpadded test step of `volume` on the CPU in float64 (the nets,
    the inputs and every op but the warp, which samples in f32 at net_T's
    f32 grid, as in f32); its scalars."""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import NETS, CSModel

    model = CSModel(cfg=cfg, device="cpu", seed=0)
    model.load_entries(entries)
    for name in NETS:
        getattr(model, name).to(torch.float64)
    model.eval()
    model._batch = tuple(torch.from_numpy(np.stack([s[i] for s in volume])).to(torch.complex128)
                         for i in (0, 1))
    model.test()
    return model.get_vis("scalars")["scalars"]


def check_eval(rng, device="cuda", shape=SHAPE, slices=EVAL_SLICES, bucket=EVAL_BUCKET,
               cpu_slices=EVAL_CPU_SLICES, cpu_bucket=EVAL_CPU_BUCKET):
    """The eval path at full width: `engine/eval.py::evaluate` (the eval
    CLI's loop: bucket padding, non-blocking staging, `CSModel.test`) over
    phantom volumes of `slices` slices with random weights for net_T, net_R
    and net_G, after a warm-up pass over the same volumes (cuDNN's choice
    of algorithms and the allocator's growth for every padded shape fall
    outside the timed loop); launch counts reset just before
    and read just after (EVAL_LAUNCHES a volume); volumes/s and slices/s
    from CUDA events, the peak device memory. Then one volume of
    `cpu_slices` on `device` against the CPU (f32) through the same
    `evaluate`, with the test step in float64 on the CPU beside them, and
    the MI bar's controls on the card's images (`mi_controls`).
    Returns the launch counts of the timed loop. (The CPU tests run it at
    a small shape on the CPU, where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.eval import _bucket_pad, evaluate

    cfg = serving_cfg(shape)
    model = CSModel(cfg=cfg, device=device, seed=0)
    entries = random_entries(model, rng, gan=True)
    model.load_entries(entries)
    model.eval()
    volumes = [eval_volume(rng, n, shape) for n in slices]
    MEASURED["eval_inputs"] = (entries, volumes, shape)  # phase 15's eval
    padded = [-(-n // bucket) * bucket for n in slices]
    is_cuda = model.device.type == "cuda"
    evaluate(model, volumes, bucket)  # warm-up: every shape the timed loop runs
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = evaluate(model, volumes, bucket)
    if is_cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for i, scalars in enumerate(stats):
        if not all(np.isfinite(v) for v in scalars.values()):
            raise AssertionError(f"eval volume {i}: non-finite scalar {scalars}")
    log(f"eval on {model.device}: {len(volumes)} volumes of {list(slices)} slices "
        f"(bucket {bucket}: {padded}), {secs * 1e3 / len(volumes):.2f} ms a volume, "
        f"{len(volumes) / secs:.3f} volumes/s, {sum(slices) / secs:.2f} slices/s "
        f"({sum(padded) / secs:.2f} with the pad slices); launches {launches}, "
        f"{ {k: v / len(volumes) for k, v in launches.items()} } a volume")
    if is_cuda:
        log(f"eval peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        want = scaled(EVAL_LAUNCHES, len(volumes))
        if launches != want:
            raise AssertionError(f"eval launches {launches}, expected {want}")
        alone = []
        for volume, n in zip(volumes, padded):  # each volume alone, after the loop
            start.record()
            evaluate(model, [volume], bucket)
            end.record()
            end.synchronize()
            alone.append(f"{n} slices {start.elapsed_time(end):.2f} ms "
                         f"({start.elapsed_time(end) / n:.2f} a slice)")
        log(f"eval, each volume alone: {'; '.join(alone)}")
    high = eval_at_precision(volumes[-1], bucket, "high", cfg=cfg, device=device, seed=0,
                             entries=entries)
    log(f"eval at --matmul_precision high on {model.device}: one volume of {slices[-1]} "
        f"slices, {high}; metric_PSNR - f32 "
        f"{high['metric_PSNR'] - stats[-1]['metric_PSNR']:.4g} dB; TF32 on in every net_R "
        f"forward, off after")

    # card against the CPU, with float64 on the CPU beside them
    small = [eval_volume(rng, cpu_slices, shape)]
    got = evaluate(model, small, cpu_bucket)[0]
    restore = _bucket_pad([np.zeros(cpu_slices)], cpu_bucket)[2]
    controls = mi_controls(model._aux["img_full_rss"][restore],
                           model._aux["img_warped_rss"][restore])
    ref_model = CSModel(cfg=cfg, device="cpu", seed=0)
    ref_model.load_entries(entries)
    ref_model.eval()
    t0 = time.perf_counter()
    want = evaluate(ref_model, small, cpu_bucket)[0]
    t1 = time.perf_counter()
    f64 = eval_f64(cfg, entries, small[0])
    t2 = time.perf_counter()
    diff = {k: abs(got[k] - v) for k, v in want.items()}
    cpu_f64 = {k: abs(v - f64[k]) for k, v in want.items()}
    log(f"eval of {cpu_slices} slices (bucket {cpu_bucket}) on {model.device} vs cpu: "
        f"{device} {got}; cpu {want}; cpu f64 (unpadded) {f64}; |{device} - cpu| "
        f"{diff}; |cpu - cpu f64| {cpu_f64}; cpu seconds f32 {t1 - t0:.1f}, "
        f"f64 {t2 - t1:.1f} (bars: PSNR {EVAL_PSNR_ATOL} dB, MI {EVAL_MI_ATOL}, "
        f"rtol {EVAL_RTOL})")
    log(f"eval metric_MI controls on {model.device} (|MI - MI of the fault| of the "
        f"{cpu_slices} slices, bar {EVAL_MI_ATOL}): {controls}")
    for k, v in want.items():
        bar = (EVAL_PSNR_ATOL if k == "metric_PSNR" else EVAL_MI_ATOL if k == "metric_MI"
               else EVAL_RTOL * abs(v))
        if not diff[k] <= bar:
            raise AssertionError(f"eval {k}: {device} {got[k]} vs cpu {v} (bar {bar})")
    for fault, moved in controls.items():
        if not moved > EVAL_MI_ATOL:
            raise AssertionError(f"eval metric_MI bar {EVAL_MI_ATOL} misses {fault}: "
                                 f"it moves MI by {moved}")
    return launches


def tf32_switches():
    """(cuDNN's, cuBLAS's) TF32 switches."""
    import torch

    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def eval_at_precision(volume, bucket, level, entries=None, **model):
    """One volume through `engine/eval.py::evaluate` on a CSModel built as
    the eval CLI builds its model at `--matmul_precision level` (`model`:
    CSModel's other arguments; `entries` loaded into it where given), then
    the CLI's return to f32 at its end. Fails unless both TF32 switches
    were as `level` asks in every net_R forward and are off after. Returns
    the volume's scalars."""
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel, f32_precision
    from spatialalignmentnetwork_tpu_torch.engine.eval import evaluate

    net = CSModel(matmul_precision=level, **model)
    if entries is not None:
        net.load_entries(entries)
    net.eval()
    seen = []
    hook = net.net_R.register_forward_pre_hook(lambda *_: seen.append(tf32_switches()))
    try:
        stats = evaluate(net, [volume], bucket)[0]
    finally:
        hook.remove()
        f32_precision()
    tf32 = level in ("default", "high")
    if not seen or set(seen) != {(tf32, tf32)}:
        raise AssertionError(f"--matmul_precision {level}: TF32 switches {set(seen)} in the "
                             f"net_R forwards, expected {(tf32, tf32)}")
    if tf32_switches() != (False, False):
        raise AssertionError(f"--matmul_precision {level}: TF32 switches {tf32_switches()} "
                             "after the eval, expected both off")
    return stats


def cli_argv(logdir, reg, ref, shape, batch, net_scale, device, mask="equispaced"):
    """The train CLI's flags for one stage of the protocol: its weights,
    PBSpline, one epoch, --seed 0 (commands_train_test.sh:27-38)."""
    return ["--logdir", logdir, "--train", "phantoms", "--val", "phantoms", "--reg", reg,
            "--protocals", "T2", ref, "--mask", mask, "--sparsity", "0.25",
            "--smooth_weight", "1000", "--gan_weight", "0.1", "--gan_sim_weight", "1",
            "--sim_weight", "1", "--aux_aug", "PBSpline", "--batch_size", str(batch),
            "--crop", str(shape), "--epoch", "1", "--intel_stop", "2e4", "--num_workers", "2",
            "--net_scale", net_scale, "--seed", "0", "--device", str(device)]


def cli_volumes(rng, slices, shape):
    """Phase 12's phantom volumes: CLI_VOLUMES a split of `slices` slices,
    train at the augmentation plane, val at `shape`; drawn once a size and
    kept for phase 13."""
    key = ("cli_volumes", slices, shape)
    if key not in MEASURED:
        aug = shape * 11 // 10
        MEASURED[key] = ([phantoms(rng, slices, aug) for _ in range(CLI_VOLUMES)],
                         [phantoms(rng, slices, shape) for _ in range(CLI_VOLUMES)])
    return MEASURED[key]


def cli_slices(vols, single=False):
    """The CLI's slices [target, aux] of volumes; aux zeros when `single`."""
    return [[full[i], np.zeros_like(aux[i]) if single else aux[i]]
            for full, aux in vols for i in range(full.shape[0])]


def check_warm_start(net, ckpt, nets):
    """Raise unless every net of `nets` in `net` equals its entries in
    checkpoint `ckpt` bit for bit."""
    from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load

    want, got = ckpt_load(ckpt), net.checkpoint(nets)
    for name in nets:
        if set(got[name]) != set(want[name]):
            raise AssertionError(f"warm start {name}: entries differ from {ckpt}")
        for key, w in want[name].items():
            if not np.array_equal(np.asarray(got[name][key]), np.asarray(w)):
                raise AssertionError(f"warm start {name} {key}: not the checkpoint's")


def check_train_cli(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH, net_scale="full",
                    slices=CLI_SLICES, workdir=None):
    """Phase 12: the train CLI's loop (`engine/train.py`: `open_model` and
    `run`, the loader, augmentation on `device`, validation, checkpoints)
    through the reference's four stages (CLI_STAGES), one epoch each, then
    one `--resume ""` epoch of the last, on phantom volumes in memory
    (CLI_VOLUMES of `slices` slices a split, train at 1.1x `shape`), then
    the eval loop (`engine/eval.py::evaluate`) on the last best.pt. Checks:
    each stage's best.pt and final checkpoint, each warm-started net equal
    to its checkpoint before the first step, `--resume ""` continuing the
    iteration count and Adam's steps, every logged scalar finite (but
    val/loss_gan_sim of a stage that does not train net_G: its fresh
    net_G's eval output overflows f32 at full width, as in the JAX
    package), the eval's scalars finite, and on a card each stage's
    launch counts (reset just before and read just after its `run`) as
    derived: steps x (STEP_LAUNCHES + PBSPLINE_LAUNCHES) + val batches x
    EVAL_LAUNCHES. Prints each stage's steps/s (host clock over the
    epoch's training, loader included) and the Proposed stage's beside
    phase 10's step time, the phase's seconds and peak device memory.
    Returns the Proposed stage's launch counts. (The CPU tests run it at a
    small shape and tiny widths on the CPU, where no kernel launches.)"""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine import train
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.eval import evaluate

    t_phase = time.perf_counter()
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    train_vols, val_vols = cli_volumes(rng, slices, shape)

    def dataset(vols, single):  # the CLI's slices [target, aux]; zeros for "None"
        return cli_slices(vols, single)

    root = workdir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                   "train_cli")
    shutil.rmtree(root, ignore_errors=True)
    stages = [(*stage, None) for stage in CLI_STAGES]
    stages.append(("Proposed, --resume", "Mixed", "T1", None, None, "Proposed"))
    launches, iters, steps_s = {}, {}, {}
    every = train.SCALARS_EVERY
    try:
        for name, reg, ref, source, nets, resumes in stages:
            logdir = os.path.join(root, resumes or name)
            argv = cli_argv(logdir, reg, ref, shape, batch, net_scale, device)
            if source:
                argv += ["--resume", os.path.join(root, source, "ckpt", "best.pt"),
                         "--load_nets", *nets]
            if resumes:
                argv += ["--resume", ""]
            if reg == "Mixed":
                argv += ["--save_opt"]  # the resumed epoch restores Adam's moments
            args = train.build_parser().parse_args(argv)
            for d in (logdir, os.path.join(logdir, "ckpt"), os.path.join(logdir, "res")):
                os.makedirs(d, exist_ok=True)
            net, iter_cnt, ckpt = train.open_model(args, train.build_cfg(args), device)
            if nets:
                check_warm_start(net, ckpt, nets)
            if resumes:
                adam = {int(st["step"]) for st in net.opt["net_R"].state.values()}
                if iter_cnt != iters[resumes] or adam != {iters[resumes]}:
                    raise AssertionError(
                        f"--resume '' took iteration {iter_cnt} and Adam steps {adam} from "
                        f"{ckpt}, expected {iters[resumes]}")
            single = ref == "None"
            train_set, val_set = dataset(train_vols, single), dataset(val_vols, single)
            steps, val_batches = len(train_set) // batch, len(val_set) // batch
            # every step's losses logged, but in the timed Proposed stage,
            # which runs at the CLI's own cadence
            train.SCALARS_EVERY = every if name == "Proposed" else 1
            kernels.reset_launches()
            rec = train.run(net, train_set, val_set, args, iter_cnt=iter_cnt)
            got = dict(kernels.LAUNCHES)
            iters[name] = rec["iter_cnt"]
            epoch = rec["epochs"][0]
            steps_s[name] = epoch["steps"] / epoch["seconds"]
            # a stage that does not train net_G logs val/loss_gan_sim of its
            # fresh net_G, whose eval-mode output with the spectral vectors
            # of its build overflows f32 at full width (as in the JAX
            # package): logged, not held
            fresh_g = {"val/loss_gan_sim"} if reg not in ("Mixed", "GAN-Only") else set()
            bad = [(t, i, v) for t, i, v in rec["scalars"]
                   if t not in fresh_g and not np.isfinite(v)]
            if bad or epoch["val"] is None:
                raise AssertionError(f"train CLI {name}: non-finite or no logged scalars {bad}")
            names = sorted(os.listdir(os.path.join(logdir, "ckpt")))
            for want in ("best.pt", "ckpt_%010d.pt" % rec["iter_cnt"]):
                if want not in names:
                    raise AssertionError(f"train CLI {name}: no {want} in {names}")
            if rec["iter_cnt"] != iter_cnt + steps or epoch["steps"] != steps:
                raise AssertionError(f"train CLI {name}: iterations {iter_cnt} -> "
                                     f"{rec['iter_cnt']}, {steps} steps expected")
            want = add_counts(scaled(add_counts(STEP_LAUNCHES[reg], PBSPLINE_LAUNCHES), steps),
                              scaled(EVAL_LAUNCHES, val_batches))
            log(f"train CLI {name} (--reg {reg}, ref {ref}"
                + (f", --load_nets {' '.join(nets)} from {source}" if nets else "")
                + (f", --resume '' at {iter_cnt}" if resumes else "")
                + f") on {net.device}: {steps} steps of {batch}, iterations {iter_cnt} -> "
                f"{rec['iter_cnt']}, {epoch['seconds']:.3f} s training, {steps_s[name]:.3f} "
                f"steps/s (host clock, loader included); val PSNR "
                f"{epoch['val']['metric_PSNR']:.4f} dB over {val_batches} batches; "
                f"launches {got}")
            if is_cuda and got != want:
                raise AssertionError(f"train CLI {name} launches {got}, expected {want}")
            launches[name] = got
            del net
            # checkpoints no later stage loads (full width: 0.2-0.6 GB each)
            for done in {"Multi-Modal": ["Multi-Modal"],
                         "Proposed": ["Single-Modal", "GAN-Only"]}.get(name, []):
                shutil.rmtree(os.path.join(root, done))
        peak_stages = torch.cuda.max_memory_allocated() if is_cuda else 0
        best = os.path.join(root, "Proposed", "ckpt", "best.pt")
        model = CSModel(ckpt=best, device=device)
        model.eval()
        volumes = [[[full[i], aux[i]] for i in range(slices)] for full, aux in val_vols]
        kernels.reset_launches()
        stats = evaluate(model, volumes, EVAL_BUCKET)
        got = dict(kernels.LAUNCHES)
        if len(stats) != CLI_VOLUMES or not all(
                np.isfinite(v) for s in stats for v in s.values()):
            raise AssertionError(f"eval of the trained best.pt: {stats}")
        if is_cuda and got != scaled(EVAL_LAUNCHES, CLI_VOLUMES):
            raise AssertionError(f"eval of the trained best.pt: launches {got}")
    finally:
        train.SCALARS_EVERY = every
        shutil.rmtree(root, ignore_errors=True)
    mixed_ms = MEASURED.get("mixed_ms")
    log(f"train CLI Proposed stage: {steps_s['Proposed']:.3f} steps/s, "
        f"{1e3 / steps_s['Proposed']:.2f} ms a step (host clock over the epoch, loader, "
        f"augmentation and the first step's start included)"
        + (f"; phase 10's Mixed step {mixed_ms:.2f} ms (CUDA events): the CLI's host path "
           f"adds {1e3 / steps_s['Proposed'] - mixed_ms:.2f} ms a step"
           if mixed_ms else "; phase 10 not run"))
    log(f"train CLI phase on {device}: {time.perf_counter() - t_phase:.1f} s"
        + (f", peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
           f"({peak_stages / 2**20:.1f} MiB over the five epochs, before the eval of "
           f"volumes padded to {EVAL_BUCKET} slices)" if is_cuda else ""))
    return launches["Proposed"]


# ---------------------------------------------------------- phase 13: masks
def mask_cfg(shape=SHAPE, reg="Rec", mask="loupe", learn_mask=True):
    """The Rec recipe (the reference's for Mixed and GAN-Only) with a mask
    of `mask` kind at MASK_SPARSITY, learned with `learn_mask`."""
    cfg = mixed_cfg(shape, reg=reg) if reg in ("Mixed", "GAN-Only") else train_cfg(shape)
    cfg.reg = reg
    cfg.mask = mask
    cfg.sparsity = MASK_SPARSITY
    cfg.learn_mask = learn_mask
    return cfg


def kept_lines(shape):
    return int(MASK_SPARSITY * shape + 0.5)


def check_mask_step(label, before, after, pruned, losses, shape):
    """Raise unless a learned-mask step moved the logits (`before` ->
    `after`), kept kept_lines() lines in `pruned` and has finite losses."""
    faults = []
    if not float((after - before).abs().max()) > 0:
        faults.append("the logits did not move")
    kept = int((~pruned).sum())
    if kept != kept_lines(shape):
        faults.append(f"{kept} lines kept, expected {kept_lines(shape)}")
    if not all(np.isfinite(float(v)) for v in losses.values()):
        faults.append(f"non-finite loss {losses}")
    if faults:
        raise AssertionError(f"{label}: {'; '.join(faults)}")


def check_loupe(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH):
    """LOUPE at full width: WARMUP + TIMED Rec updates with the mask fixed
    (learn_mask off), then as many learning it, from the same weights and
    batches, each on CUDA events; then one None and one Mixed update
    learning it. After every learned step: the logits moved, exactly
    kept_lines() lines kept, every loss finite; on a card the launch
    counts of each regime (REC_LAUNCHES, NONE_LAUNCHES, MIXED_LAUNCHES).
    Prints both Rec step times and the learned steps' peak device memory.
    Returns the learned steps' launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    is_cuda = torch.device(device).type == "cuda"
    model = CSModel(cfg=mask_cfg(shape, learn_mask=False), device=device, seed=0)
    entries = random_entries(model, rng)
    model.load_entries(entries)
    batches = [phantoms(rng, batch, shape) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    fixed = model.net_mask.weight.detach().clone()
    plain_secs, _, _ = timed_steps(model, batches, lambda b: b)
    if not torch.equal(model.net_mask.weight.detach(), fixed):
        raise AssertionError("LOUPE without learn_mask: the logits moved")
    del model
    model = CSModel(cfg=mask_cfg(shape), device=device, seed=0)
    model.load_entries(entries)
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    steps = []
    for i, b in enumerate(batches):
        if i == WARMUP_STEPS:
            if is_cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
        before = model.net_mask.weight.detach().clone()
        model.set_input(*b)
        model.update()
        steps.append((before, model.net_mask.weight.detach().clone(), model.pruned.clone(),
                      dict(model._aux)))
    if is_cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for i, step in enumerate(steps):
        check_mask_step(f"LOUPE Rec step {i}", *step, shape)
    ms, plain_ms = secs * 1e3 / TIMED_STEPS, plain_secs * 1e3 / TIMED_STEPS
    MEASURED["loupe_rec_ms"] = ms
    clock = "CUDA events" if is_cuda else "host clock"
    log(f"LOUPE Rec train (learned mask, {kept_lines(shape)} of {shape} lines) on "
        f"{model.device}: batch {batch}, {shape}x{shape}, {len(batches)} steps "
        f"({WARMUP_STEPS} warm-up), {ms:.2f} ms per step ({clock}), the Rec step "
        f"with the mask fixed {plain_ms:.2f} ms ({ms / plain_ms:.3f}x); last losses "
        f"{ {k: float(v) for k, v in steps[-1][3].items()} }; launches {launches}")
    if is_cuda:
        log(f"LOUPE Rec train peak device memory: "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        want = scaled(REC_LAUNCHES, len(batches))
        if launches != want:
            raise AssertionError(f"LOUPE Rec launches {launches}, expected {want}")
    out = [launches]
    for reg, want in (("None", NONE_LAUNCHES), ("Mixed", MIXED_LAUNCHES)):
        del model
        model = CSModel(cfg=mask_cfg(shape, reg), device=device, seed=0)
        model.load_entries(entries)
        model.set_input(*phantoms(rng, batch, shape))
        before = model.net_mask.weight.detach().clone()
        if is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launches()
        model.update()
        got = dict(kernels.LAUNCHES)
        losses = model.get_vis("scalars")["scalars"]
        log(f"LOUPE {reg} step (learned mask) on {model.device}: batch {batch}, "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock, one step, its "
            f"first); losses {losses}; launches {got}")
        check_mask_step(f"LOUPE {reg} step", before, model.net_mask.weight.detach(),
                        model.pruned, losses, shape)
        if is_cuda and got != want:
            raise AssertionError(f"LOUPE {reg} launches {got}, expected {want}")
        out.append(got)
    return add_counts(*out)


def check_taylor(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH, num=TAYLOR_PRUNE):
    """Taylor saliency at full width: one warm-up `taylor_step`, dropped
    by `prune(0)`, then TAYLOR_BATCHES steps on CUDA events and
    `prune(num)`; the same steps on the CPU in float64. Checks: the mean
    saliency within TAYLOR_TOL of float64's max, `num` more lines pruned,
    the pruned set float64's for every line whose float64 saliency lies
    farther than twice the measured error from the cut (such a line cannot
    cross it; all of them where the gap at the cut is wider than that),
    no BatchNorm statistic moved,
    on a card TAYLOR_LAUNCHES a step. Returns the launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    is_cuda = torch.device(device).type == "cuda"
    cfg = mask_cfg(shape, "None", mask="taylor", learn_mask=False)
    model = CSModel(cfg=cfg, device=device, seed=0)
    entries = random_entries(model, rng)
    model.load_entries(entries)
    data = [phantoms(rng, batch, shape) for _ in range(TAYLOR_BATCHES + 1)]
    model.set_input(*data[0])
    model.taylor_step()
    model.prune(0)
    stats = {k: v.clone() for k, v in model.net_T.state_dict().items()}
    pruned0 = model.pruned.clone()
    if is_cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    kernels.reset_launches()
    for b in data[1:]:
        model.set_input(*b)
        model.taylor_step()
    if is_cuda:
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
    else:
        secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    model.prune(num)
    got = model.net_mask.weight.detach().cpu().double()  # the mean: none was pruned
    moved = [k for k, v in model.net_T.state_dict().items() if not torch.equal(v, stats[k])]
    t0 = time.perf_counter()
    ref_model = f64_model(cfg, entries)
    for b in data[1:]:
        ref_model._batch = tuple(torch.from_numpy(x).to(torch.complex128) for x in b)
        ref_model.taylor_step()
    ref = torch.stack(ref_model._taylor_values).mean(0)
    f64_secs = time.perf_counter() - t0
    top = float(ref.abs().max())
    err = float((got - ref).abs().max()) / top
    order = torch.argsort(ref)
    gap = float(ref[order[num]] - ref[order[num - 1]]) / top
    want_set = set(order[:num].tolist())
    got_set = set(torch.nonzero(model.pruned.cpu() & ~pruned0.cpu()).flatten().tolist())
    # a line whose float64 saliency lies farther than 2 err from the cut
    # cannot cross it: the pruned set is held there
    cut = float(ref[order[num - 1]] + ref[order[num]]) / 2
    crossed = sorted(i for i in range(ref.shape[0])
                     if abs(float(ref[i]) - cut) > 2 * err * top
                     and (i in got_set) != (float(ref[i]) < cut))
    ms = secs * 1e3 / TAYLOR_BATCHES
    rec_ms = MEASURED.get("loupe_rec_ms")
    clock = "CUDA events" if is_cuda else "host clock"
    log(f"Taylor step on {model.device}: batch {batch}, {shape}x{shape}, {ms:.2f} ms a step "
        f"({clock}, {TAYLOR_BATCHES} steps)"
        + (f", {ms / rec_ms:.3f} of the LOUPE Rec step" if rec_ms else "")
        + f"; launches {launches}; saliency max|diff| {err:.3g} of float64's max (tol "
        f"{TAYLOR_TOL}; float64 {f64_secs:.1f} s on the cpu); prune({num}): lines "
        f"{sorted(got_set)}, float64's {sorted(want_set)}, gap at the cut {gap:.3g} of "
        f"the max; lines held to float64's side of the cut "
        f"{sum(abs(float(v) - cut) > 2 * err * top for v in ref)} of {ref.shape[0]}")
    if not err <= TAYLOR_TOL:
        raise AssertionError(f"Taylor saliency: {err} of float64's max (bar {TAYLOR_TOL})")
    if len(got_set) != num or int(model.pruned.sum()) != int(pruned0.sum()) + num:
        raise AssertionError(f"prune({num}) pruned {sorted(got_set)}")
    if crossed:
        raise AssertionError(f"prune({num}): lines {sorted(got_set)}, float64's "
                             f"{sorted(want_set)}; lines {crossed} cross the cut by "
                             f"more than twice the saliency's error")
    if moved:
        raise AssertionError(f"taylor_step moved net_T's statistics {moved[:3]}")
    if is_cuda and launches != scaled(TAYLOR_LAUNCHES, TAYLOR_BATCHES):
        raise AssertionError(f"Taylor launches {launches}, expected "
                             f"{scaled(TAYLOR_LAUNCHES, TAYLOR_BATCHES)}")
    return launches


def check_mask_cli(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH, net_scale="full",
                   slices=CLI_SLICES, workdir=None, prune_num=TAYLOR_PRUNE):
    """The train CLI's mask learning on phase 12's phantom volumes, one
    epoch each: `--mask loupe --learn_mask --reg Rec`, and `--mask taylor
    --prune_every CLI_PRUNE_EVERY --prune_num prune_num --reg None`. Each
    run's final checkpoint reloads with the live model's `pruned` and
    net_mask weight; LOUPE keeps kept_lines() lines and its logits moved,
    the schedule prunes prune_num lines at each round and logs the keep
    density; on a card the launch counts: steps x (the step's + Taylor's
    where it runs + PBSPLINE_LAUNCHES) + val batches x EVAL_LAUNCHES.
    Returns the launch counts of both runs."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine import train
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    is_cuda = torch.device(device).type == "cuda"
    train_vols, val_vols = cli_volumes(rng, slices, shape)
    train_set, val_set = cli_slices(train_vols), cli_slices(val_vols)
    steps, val_batches = len(train_set) // batch, len(val_set) // batch
    root = workdir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                   "mask_cli")
    shutil.rmtree(root, ignore_errors=True)
    runs = (("loupe", "Rec", ["--learn_mask"], REC_LAUNCHES),
            ("taylor", "None", ["--prune_every", str(CLI_PRUNE_EVERY), "--prune_num",
                                str(prune_num)], add_counts(NONE_LAUNCHES, TAYLOR_LAUNCHES)))
    out = []
    try:
        for mask, reg, extra, step_launches in runs:
            logdir = os.path.join(root, mask)
            args = train.build_parser().parse_args(
                cli_argv(logdir, reg, "T1", shape, batch, net_scale, device, mask) + extra)
            for d in (logdir, os.path.join(logdir, "ckpt"), os.path.join(logdir, "res")):
                os.makedirs(d, exist_ok=True)
            net, iter_cnt, _ = train.open_model(args, train.build_cfg(args), device)
            start = (net.net_mask.weight.detach().clone()
                     if net.net_mask.weight is not None else None)
            kernels.reset_launches()
            rec = train.run(net, train_set, val_set, args, iter_cnt=iter_cnt)
            got = dict(kernels.LAUNCHES)
            saved = CSModel(ckpt=os.path.join(logdir, "ckpt", "ckpt_%010d.pt" % rec["iter_cnt"]),
                            device=device)
            faults = []
            if not torch.equal(saved.pruned, net.pruned):
                faults.append("the checkpoint's pruned is not the live model's")
            if not torch.equal(saved.net_mask.weight, net.net_mask.weight):
                faults.append("the checkpoint's weight is not the live model's")
            rounds = steps // CLI_PRUNE_EVERY if mask == "taylor" else 0
            want_pruned = rounds * prune_num if mask == "taylor" else shape - kept_lines(shape)
            if int(net.pruned.sum()) != want_pruned:
                faults.append(f"{int(net.pruned.sum())} lines pruned, expected {want_pruned}")
            if [i for i, _ in rec["prunes"]] != [CLI_PRUNE_EVERY * (r + 1) for r in range(rounds)]:
                faults.append(f"prune rounds {rec['prunes']}")
            if start is not None and torch.equal(start, net.net_mask.weight.detach()):
                faults.append("the logits did not move")
            # val/loss_gan_sim is the fresh net_G's, which neither run trains
            # (phase 12: its eval output overflows f32 at full width)
            if not all(np.isfinite(v) for t, _, v in rec["scalars"] if t != "val/loss_gan_sim"):
                faults.append("a non-finite logged scalar")
            want = add_counts(scaled(add_counts(step_launches, PBSPLINE_LAUNCHES), steps),
                              scaled(EVAL_LAUNCHES, val_batches))
            if is_cuda and got != want:
                faults.append(f"launches {got}, expected {want}")
            log(f"train CLI --mask {mask} {' '.join(extra)} --reg {reg} on {net.device}: "
                f"{steps} steps of {batch}, {int((~net.pruned).sum())} of {shape} lines kept, "
                f"prunes (iteration, keep density) {rec['prunes']}, val PSNR "
                f"{rec['epochs'][0]['val']['metric_PSNR']:.4f} dB; its checkpoint's pruned "
                f"and weight reload as the live model's; launches {got}")
            if faults:
                raise AssertionError(f"train CLI --mask {mask}: {'; '.join(faults)}")
            out.append(got)
            del net, saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return add_counts(*out)


def check_masks(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH, net_scale="full",
                slices=CLI_SLICES, workdir=None, prune_num=TAYLOR_PRUNE):
    """Phase 13: LOUPE's learned mask in the Rec, None and Mixed steps
    (`check_loupe`), one learned Rec step at batch 2 against float64 with
    its planted fault (`check_train_vs_cpu`), Taylor saliency and pruning
    (`check_taylor`), and the train CLI's `--learn_mask` and prune
    schedule (`check_mask_cli`). Returns the launch counts of the steps,
    the Taylor steps and the CLI runs."""
    import torch

    t_phase = time.perf_counter()
    is_cuda = torch.device(device).type == "cuda"
    launches = [check_loupe(rng, device, shape, batch)]
    check_train_vs_cpu(rng, device, shape, learn_mask=True)
    launches.append(check_taylor(rng, device, shape, batch, prune_num))
    launches.append(check_mask_cli(rng, device, shape, batch, net_scale, slices, workdir,
                                   prune_num))
    log(f"mask phase on {device}: {time.perf_counter() - t_phase:.1f} s"
        + (f", peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
           "since the LOUPE steps began" if is_cuda else ""))
    return add_counts(*launches)


def mi_controls(full, warped):
    """How far metric_MI of (full, warped) [S, 1, H, W] moves under the two
    faults its bar must catch: the warped image one pixel off along W, and
    the first slice binned with its bin edges half a bin off."""
    from spatialalignmentnetwork_tpu_torch.utils import metrics_torch as metrics

    per_slice = metrics.mi_per_slice(full, warped)
    half = 0.5 / 64
    misbinned = per_slice.clone()
    misbinned[0] = metrics.mi_per_slice(full[:1], warped[:1], minVal=-half,
                                        maxVal=1.0 - half)[0]
    mi = per_slice.mean()
    return {"warp one pixel off": abs(float(metrics.mi(full, warped.roll(1, dims=-1)) - mi)),
            "one slice binned half a bin off": abs(float(misbinned.mean() - mi))}


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
# ------------------------------------------------------------- precision
BIG_BATCH = 16  # the bf16 Mixed step at the JAX package's flagship train batch
REMAT_TG_BATCH = 24  # `_remat_tg`'s net_T threshold (net_G's half batch: 12)
NETS = ("net_T", "net_R", "net_G", "net_D")
# serving's slice 0, card bf16 against CPU bf16: relative L2 within the
# larger of SERVE_BF16_L2 and BF16_OWN times the CPU's own bf16 distance
# from its f32 (at full width on random weights a bf16 reconstruction lies
# 0.13-0.20 from f32, the JAX package's as the port's)
BF16_OWN = 1.5
SERVE_BF16_L2 = 5e-2
BF16_LOSS_TOL = 5e-2  # a bf16 step's losses, |card - cpu| / max(|cpu|, 1e-2)
REMAT_GRAD_TOL = 1e-5  # remat on vs off, of each net's max |grad|
REMAT_STATS_TOL = 1e-6  # ... BatchNorm running statistics, of their max


def precision_cfg(reg="Rec", shape=SHAPE, use_amp=True, remat=False, widths=None, **extra):
    """The Rec (or, for the GAN regimes, the Mixed) recipe under the bf16
    policy `use_amp` and net_R's per-cascade remat; `widths`, cfg entries
    that narrow the nets (the CPU test's), else `build`'s defaults."""
    cfg = train_cfg(shape) if reg in ("None", "Rec") else mixed_cfg(shape, reg=reg)
    cfg.reg = reg
    cfg.use_amp = use_amp
    cfg.net_R_remat = remat
    for k, v in {**(widths or {}), **extra}.items():
        setattr(cfg, k, v)
    return cfg


@contextlib.contextmanager
def net_dtypes(model):
    """While the block runs, the output dtype of every conv, transposed
    conv, BatchNorm, spectral-norm conv and instance norm of the model's
    four nets that runs: a set of (net, dtype)."""
    import torch

    from spatialalignmentnetwork_tpu_torch.models.gan import SpectralConv
    from spatialalignmentnetwork_tpu_torch.models.layers import InstanceNorm

    sites = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.BatchNorm2d, SpectralConv,
             InstanceNorm)
    seen = set()
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: seen.add((name, o.dtype)))
             for name in NETS for m in getattr(model, name).modules() if isinstance(m, sites)]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def check_net_dtypes(seen, dtype, nets, what):
    """Raise unless each of `nets` ran and every conv and norm that ran
    gave `dtype` (bf16 under use_amp, f32 without), as `net_dtypes`
    recorded them."""
    wrong = sorted(f"{n}: {d}" for n, d in seen if d != dtype)
    missing = sorted(set(nets) - {n for n, _ in seen})
    if wrong or missing:
        raise AssertionError(f"{what}: convs and norms not in {dtype}: {wrong}; nets that "
                             f"did not run: {missing}")


def rel_l2(got, want):
    """||got - want|| / ||want|| of two tensors, in float64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


def loss_error(got, want):
    """The worst |got - want| / max(|want|, 1e-2) over two loss dicts."""
    if set(got) != set(want):
        raise AssertionError(f"losses {sorted(got)} vs {sorted(want)}")
    return max(abs(got[k] - v) / max(abs(v), 1e-2) for k, v in want.items())


def free_card():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_mib():
    import torch

    return torch.cuda.max_memory_allocated() / 2**20


def serve_bf16(rng, entries, device, shape, batch, widths=None):
    """Serving in bf16 at `batch`: WARMUP + TIMED requests, slices/s and
    the peak, the nets' convs and norms in bf16 (the warm-up requests);
    slice 0 against the port's bf16 and f32 on the CPU. Returns the launch
    counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    model = CSModel(cfg=precision_cfg("Rec", shape, widths=widths), device=device, seed=0)
    model.load_entries(entries)
    requests = [phantoms(rng, batch, shape) for _ in range(WARMUP_REQUESTS + TIMED_REQUESTS)]
    is_cuda = model.device.type == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with net_dtypes(model) as seen:
        outs = [model.reconstruct(*r) for r in requests[:WARMUP_REQUESTS]]
    check_net_dtypes(seen, torch.bfloat16, ("net_T", "net_R"), "bf16 serving")
    if is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cuda_timer(is_cuda) as timer:
        outs += [model.reconstruct(*r) for r in requests[WARMUP_REQUESTS:]]
    secs = timer.secs if is_cuda else time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for out in outs:
        if out.shape != (batch, 1, shape, shape) or not torch.isfinite(out).all():
            raise AssertionError(f"bf16 serving: bad output {tuple(out.shape)}")
    got = outs[0][0].cpu()
    del model
    free_card()
    refs = {}
    for amp in (True, False):
        ref_model = CSModel(cfg=precision_cfg("Rec", shape, use_amp=amp, widths=widths),
                            device="cpu", seed=0)
        ref_model.load_entries(entries)
        refs[amp] = ref_model.reconstruct(*(x[:1] for x in requests[0]))[0]
    err, err32 = rel_l2(got, refs[True]), rel_l2(got, refs[False])
    own = rel_l2(refs[True], refs[False])
    bar = max(SERVE_BF16_L2, BF16_OWN * own)
    log(f"bf16 serving on {device}: {len(requests)} requests of {batch} slices "
        f"({WARMUP_REQUESTS} warm-up), {secs * 1e3 / TIMED_REQUESTS:.2f} ms per request, "
        f"{TIMED_REQUESTS * batch / secs:.2f} slices/s; launches {launches}; peak "
        f"{peak_mib() if is_cuda else 0:.1f} MiB; slice 0, relative L2: vs the CPU's bf16 "
        f"{err:.4g} (bar {bar:.4g}), vs the CPU's f32 {err32:.4g}, the CPU's bf16 vs its "
        f"f32 {own:.4g}")
    MEASURED["bf16_serving_slices_s"] = TIMED_REQUESTS * batch / secs
    if is_cuda and launches.get("grid_sample_fwd", 0) != len(requests):
        raise AssertionError(f"bf16 serving launches {launches}")
    if not err <= bar:
        raise AssertionError("bf16 serving: the card's slice 0 is off the CPU's")
    return launches


@contextlib.contextmanager
def cuda_timer(enabled=True):
    """CUDA events around the block; `.secs` after it (0 when disabled)."""
    import torch

    timer = types.SimpleNamespace(secs=0.0)
    if not enabled:
        yield timer
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield timer
    end.record()
    end.synchronize()
    timer.secs = start.elapsed_time(end) / 1e3


def train_bf16(rng, entries, device, shape, batch, widths=None):
    """The Rec and the Mixed (PBSpline 352 -> 320) steps in bf16 at
    `batch`: WARMUP + TIMED steps each, ms, peak, finite losses; then one
    step of each at batch 2 on the card and on the CPU, in bf16 from the
    same weights and inputs: the losses, and every conv and norm of the
    step's nets in bf16 on both. Returns the launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    counts = []
    for reg, want, nets in (("Rec", REC_LAUNCHES, ("net_T", "net_R")),
                            ("Mixed", add_counts(MIXED_LAUNCHES, PBSPLINE_LAUNCHES), NETS)):
        model = CSModel(cfg=precision_cfg(reg, shape, widths=widths), device=device, seed=0)
        model.load_entries(entries)
        if reg == "Rec":
            batches = [phantoms(rng, batch, shape) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
            prepare = lambda b: b  # noqa: E731
        else:
            gen = torch.Generator(device=model.device).manual_seed(0)
            batches = [phantoms(rng, batch, shape * 11 // 10)
                       for _ in range(WARMUP_STEPS + TIMED_STEPS)]
            prepare = lambda b: augmented_batch(*b, gen, model.device, shape)  # noqa: E731
        secs, launches, losses = timed_steps(model, batches, prepare)
        is_cuda = model.device.type == "cuda"
        MEASURED[f"bf16_{reg}_ms"] = secs * 1e3 / TIMED_STEPS
        log(f"bf16 {reg} train on {device}: batch {batch}, {shape}x{shape}, "
            f"{len(batches)} steps ({WARMUP_STEPS} warm-up), "
            f"{secs * 1e3 / TIMED_STEPS:.2f} ms per step, {TIMED_STEPS * batch / secs:.2f} "
            f"slices/s, peak {peak_mib() if is_cuda else 0:.1f} MiB; last losses "
            f"{losses[-1]}; launches {launches}")
        if is_cuda and launches != scaled(want, len(batches)):
            raise AssertionError(f"bf16 {reg} launches {launches}")
        counts.append(launches)
        del model
        free_card()
        full, aux = phantoms(rng, 2, shape)
        step, secs = {}, {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            model = CSModel(cfg=precision_cfg(reg, shape, widths=widths), device=dev, seed=0)
            model.load_entries(entries)
            model.set_input(full, aux)
            with net_dtypes(model) as seen:
                model.update()
            check_net_dtypes(seen, torch.bfloat16, nets, f"bf16 {reg} step on {dev}")
            step[dev] = model.get_vis("scalars")["scalars"]
            secs[dev] = round(time.perf_counter() - t0, 1)
            del model
        free_card()
        err = loss_error(step[device], step["cpu"])
        log(f"one bf16 {reg} step, batch 2, {device} vs cpu: {step[device]} vs "
            f"{step['cpu']}: worst |diff| / max(|cpu|, 1e-2) {err:.4g} (tol "
            f"{BF16_LOSS_TOL}); seconds {secs}")
        if not err <= BF16_LOSS_TOL:
            raise AssertionError(f"bf16 {reg} step: the card's losses are off the CPU's")
    return add_counts(*counts)


def remat_f32(rng, entries, device, shape, batch, widths=None):
    """The f32 Rec step with net_R_remat off and on, one model at a time
    from the same weights and batches: step 0's gradients (within
    REMAT_GRAD_TOL of each net's max; every conv and norm in f32); then
    WARMUP + TIMED steps each, ms and peak. Returns the launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    first = phantoms(rng, batch, shape)
    batches = [phantoms(rng, batch, shape) for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    grads, counts, res = {}, [], {}
    for remat in (False, True):
        model = CSModel(cfg=precision_cfg("Rec", shape, use_amp=False, remat=remat,
                                          widths=widths), device=device, seed=0)
        model.load_entries(entries)
        model.set_input(*first)
        with net_dtypes(model) as seen:
            model.update()
        check_net_dtypes(seen, torch.float32, ("net_T", "net_R"), f"f32 Rec (remat {remat})")
        grads[remat] = net_grads(model)
        secs, launches, _ = timed_steps(model, batches, lambda b: b)
        is_cuda = model.device.type == "cuda"
        res[remat] = (secs * 1e3 / TIMED_STEPS, peak_mib() if is_cuda else 0.0)
        MEASURED[f"f32_rec_remat_{remat}"] = res[remat]
        counts.append(launches)
        if is_cuda and launches != scaled(REC_LAUNCHES, len(batches)):
            raise AssertionError(f"f32 Rec (remat {remat}) launches {launches}")
        del model
        free_card()
    err = grad_error(grads[True], {n: {k: g.double() for k, g in leaves.items()}
                                   for n, leaves in grads[False].items()})
    log(f"f32 Rec train on {device}, batch {batch}: net_R_remat off {res[False][0]:.2f} ms "
        f"a step, peak {res[False][1]:.1f} MiB; on {res[True][0]:.2f} ms, peak "
        f"{res[True][1]:.1f} MiB; step 0 gradients, remat on vs off, worst leaf's max "
        f"|diff| / net's max {err} (tol {REMAT_GRAD_TOL})")
    if not all(e <= REMAT_GRAD_TOL for e, _ in err.values()):
        raise AssertionError("net_R_remat changes the Rec step")
    return add_counts(*counts)


@contextlib.contextmanager
def counting_remat(remat_tg=True):
    """Count, while the block runs, the checkpointed calls
    (`models/remat.py::checkpoint`) and the stateful values their
    recomputations replay (`replay`); with `remat_tg` False, `_remat_tg`
    is off (no net_T or net_G forward is rematerialized)."""
    from spatialalignmentnetwork_tpu_torch.engine import csmodel
    from spatialalignmentnetwork_tpu_torch.models import remat

    counts = {"checkpoint": 0, "replay": 0}
    saved = remat.checkpoint, remat.replay, csmodel._remat_tg

    def checkpoint(fn, *args):
        counts["checkpoint"] += 1
        return saved[0](fn, *args)

    def replay():
        counts["replay"] += 1
        return saved[1]()

    remat.checkpoint, remat.replay = checkpoint, replay
    if not remat_tg:
        csmodel._remat_tg = lambda batch, threshold=24: False
    try:
        yield counts
    finally:
        remat.checkpoint, remat.replay, csmodel._remat_tg = saved


def remat_tg_bf16(rng, entries, device, shape, batch=REMAT_TG_BATCH, widths=None):
    """One bf16 Mixed step at `batch` (24), where `_remat_tg`
    rematerializes net_T's forward and net_G's two (half batches of 12),
    against the same step with it off, from the same weights and batch,
    net_R_remat on in both, cuDNN deterministic: every net's gradients
    within REMAT_GRAD_TOL of its max, every BatchNorm statistic and
    spectral-norm vector (u, v) of the four nets within REMAT_STATS_TOL of
    its max; and the counts of checkpointed calls (one a cascade of
    net_R, 3 more with `_remat_tg`) and of replayed (u, v) (each of
    net_G's spectral-norm convs in each of its 2 recomputed calls).
    Returns the launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.models.gan import SpectralConv

    full, aux = phantoms(rng, batch, shape)
    out, launches = {}, []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for on in (False, True):
            cfg = precision_cfg("Mixed", shape, remat=True, widths=widths)
            model = CSModel(cfg=cfg, device=device, seed=0)
            model.load_entries(entries)
            model.set_input(full, aux)
            kernels.reset_launches()
            with counting_remat(remat_tg=on) as counts, net_dtypes(model) as seen:
                model.update()
            launches.append(dict(kernels.LAUNCHES))
            check_net_dtypes(seen, torch.bfloat16, NETS, f"bf16 Mixed, _remat_tg {on}")
            snconvs = sum(isinstance(m, SpectralConv) for m in model.net_G.modules())
            want = {"checkpoint": len(model.net_R.cascades) + (3 if on else 0),
                    "replay": 2 * snconvs if on else 0}
            if counts != want:
                raise AssertionError(f"_remat_tg {on}: {counts}, expected {want}")
            buffers = {f"{n}.{k}": v.detach().double().cpu() for n in NETS
                       for k, v in getattr(model, n).named_buffers()
                       if not k.endswith("num_batches_tracked")}
            out[on] = (net_grads(model), buffers, model.get_vis("scalars")["scalars"])
            del model
            free_card()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (grads, stats, losses), (grads_off, stats_off, losses_off) = out[True], out[False]
    err = grad_error(grads, {n: {k: g.double() for k, g in leaves.items()}
                             for n, leaves in grads_off.items()})
    stat_err = max(float((stats[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                   for k, v in stats_off.items())
    log(f"bf16 Mixed train on {device}, batch {batch}: _remat_tg on vs off (net_R_remat on), "
        f"worst leaf's max |diff| / net's max {err} (tol {REMAT_GRAD_TOL}); BatchNorm "
        f"statistics and u, v of {len(stats)} buffers: {stat_err:.3g} of their max (tol "
        f"{REMAT_STATS_TOL}); losses {losses} vs {losses_off}; launches {launches}")
    if not set(NETS) <= set(err) or not all(e <= REMAT_GRAD_TOL for e, _ in err.values()):
        raise AssertionError("_remat_tg changes the Mixed step's gradients")
    if not stat_err <= REMAT_STATS_TOL:
        raise AssertionError("_remat_tg changes the Mixed step's statistics or u, v")
    if device != "cpu" and launches != [MIXED_LAUNCHES] * 2:
        raise AssertionError(f"bf16 Mixed batch {batch} launches {launches}")
    return add_counts(*launches)


def mixed_bf16_big(rng, entries, device, shape, batch=BIG_BATCH, widths=None):
    """The bf16 Mixed step (phantoms at `shape`) at `batch`, the JAX
    package's flagship train batch, with net_R_remat off and on: one
    warm-up and two timed steps each, ms and peak. Returns the launch
    counts."""
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    counts = []
    for remat in (False, True):
        model = CSModel(cfg=precision_cfg("Mixed", shape, remat=remat, widths=widths),
                        device=device, seed=0)
        model.load_entries(entries)
        steps = [phantoms(rng, batch, shape) for _ in range(3)]
        secs, launches, losses = timed_steps(model, steps, lambda b: b, warmup=1)
        is_cuda = model.device.type == "cuda"
        ms = secs * 1e3 / 2
        MEASURED[f"bf16_mixed_b{batch}_remat_{remat}"] = (ms, peak_mib() if is_cuda else 0)
        log(f"bf16 Mixed train on {device}: batch {batch}, net_R_remat {remat}, "
            f"{ms:.2f} ms per step (2 timed after 1 warm-up), {2 * batch / secs:.2f} "
            f"slices/s, peak {peak_mib() if is_cuda else 0:.1f} MiB; last losses "
            f"{losses[-1]}; launches {launches}")
        if is_cuda and launches != scaled(MIXED_LAUNCHES, 3):
            raise AssertionError(f"bf16 Mixed batch {batch} launches {launches}")
        counts.append(launches)
        del model
        free_card()
    return add_counts(*counts)


def entries_bf16(rng, entries, device, shape, batch, widths=None):
    """One step each in bf16 of the None regime, GAN-Only at grad_accum 2,
    and the LOUPE learned Rec step (sparsity MASK_SPARSITY): finite losses,
    their launches, and every conv and norm of the nets the step runs in
    bf16. Returns the launch counts."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    counts = []
    for label, cfg, n, want, nets in (
            ("None", precision_cfg("None", shape, widths=widths), batch, NONE_LAUNCHES,
             ("net_R",)),
            # micro-batches of at least 2 for forwardG's crossover
            ("GAN-Only grad_accum 2",
             precision_cfg("GAN-Only", shape, widths=widths, grad_accum=2), max(batch, 4),
             scaled(GAN_ONLY_LAUNCHES, 2), ("net_T", "net_G", "net_D")),
            ("LOUPE learned Rec",
             precision_cfg("Rec", shape, widths=widths, mask="loupe", sparsity=MASK_SPARSITY,
                           learn_mask=True), batch, REC_LAUNCHES, ("net_T", "net_R"))):
        model = CSModel(cfg=cfg, device=device, seed=0)
        model.load_entries(entries)
        model.set_input(*phantoms(rng, n, shape))
        kernels.reset_launches()
        with net_dtypes(model) as seen:
            model.update()
        launches = dict(kernels.LAUNCHES)
        check_net_dtypes(seen, torch.bfloat16, nets, f"bf16 {label} step")
        losses = model.get_vis("scalars")["scalars"]
        log(f"bf16 {label} step on {device}: batch {n}; losses {losses}; "
            f"launches {launches}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"bf16 {label}: non-finite loss {losses}")
        if model.device.type == "cuda" and launches != want:
            raise AssertionError(f"bf16 {label} launches {launches}, expected {want}")
        counts.append(launches)
        del model
        free_card()
    return add_counts(*counts)


def eval_bf16(rng, entries, device, shape, slices=EVAL_BUCKET, widths=None):
    """One volume of `slices` through `engine/eval.py::evaluate` on a bf16
    model (after a warm-up pass), beside the f32 model on the same volume:
    finite scalars, the reconstructions' relative L2, both PSNRs, and the
    nets' convs and norms in bf16 (f32) on the warm-up pass. Returns the
    launch counts of the bf16 pass."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.eval import evaluate

    volume = eval_volume(rng, slices, shape)
    out = {}
    for amp in (True, False):
        model = CSModel(cfg=precision_cfg("Rec", shape, use_amp=amp, widths=widths),
                        device=device, seed=0)
        model.load_entries(entries)
        model.eval()
        with net_dtypes(model) as seen:
            evaluate(model, [volume], EVAL_BUCKET)
        check_net_dtypes(seen, torch.bfloat16 if amp else torch.float32,
                         ("net_T", "net_R"), f"eval (use_amp {amp})")
        kernels.reset_launches()
        t0 = time.perf_counter()
        stats = evaluate(model, [volume], EVAL_BUCKET)[0]
        out[amp] = (stats, dict(kernels.LAUNCHES),
                    torch.from_numpy(model.get_vis("images")["images"]["img_rec"]),
                    time.perf_counter() - t0)
        del model
        free_card()
    (stats, launches, rec, secs), (stats32, _, rec32, _) = out[True], out[False]
    err = rel_l2(rec, rec32)
    log(f"bf16 eval on {device}: one volume of {slices} slices, {secs * 1e3:.1f} ms (host "
        f"clock), {stats}; f32 {stats32}; metric_PSNR bf16 - f32 "
        f"{stats['metric_PSNR'] - stats32['metric_PSNR']:.4g} dB; reconstructions' "
        f"relative L2 {err:.4g}; launches {launches}")
    if rec.shape != (slices, 1, shape, shape) or not all(np.isfinite(v) for v in stats.values()):
        raise AssertionError(f"bf16 eval: {tuple(rec.shape)}, scalars {stats}")
    if device != "cpu" and launches != EVAL_LAUNCHES:
        raise AssertionError(f"bf16 eval launches {launches}")
    return launches


def check_precision(rng, device="cuda", shape=SHAPE, serve_batch=BATCH, batch=TRAIN_BATCH,
                    big=BIG_BATCH, remat_tg_batch=REMAT_TG_BATCH, widths=None):
    """Phase 14, the precision and memory policy: bf16 serving, the bf16
    Rec and Mixed steps, the f32 Rec step with net_R_remat off and on, the
    bf16 Mixed step with `_remat_tg` on and off, the bf16 Mixed step at
    the JAX package's flagship batch with remat off and on, the bf16
    None, GAN-Only (grad_accum 2) and LOUPE steps, and one bf16 eval
    volume. Returns the launch counts of its runs. (The CPU tests run it
    at a small shape, narrow `widths` and small batches on the CPU, where
    no kernel launches.)"""
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    t0 = time.perf_counter()
    free_card()  # the cache earlier phases left
    template = CSModel(cfg=precision_cfg("Mixed", shape, widths=widths), device="cpu", seed=0)
    entries = random_entries(template, rng, gan=True)
    del template
    counts = [serve_bf16(rng, entries, device, shape, serve_batch, widths),
              train_bf16(rng, entries, device, shape, batch, widths),
              remat_f32(rng, entries, device, shape, batch, widths),
              remat_tg_bf16(rng, entries, device, shape, remat_tg_batch, widths),
              mixed_bf16_big(rng, entries, device, shape, big, widths),
              entries_bf16(rng, entries, device, shape, batch, widths),
              eval_bf16(rng, entries, device, shape, widths=widths)]
    log(f"precision phase on {device}: {time.perf_counter() - t0:.1f} s")
    return add_counts(*counts)


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
    # the template arguments up to their closing E: literals L<type><value>E
    # (Li16E -> 16, Lb1E -> true), length-prefixed names, one-letter types
    args, i, tail = [], end + 1, mangled
    while i < len(tail) and tail[i] != "E":
        if tail[i] == "L":
            j = tail.index("E", i)
            lit = tail[i + 1:j]
            args.append({"b0": "false", "b1": "true"}.get(lit, lit[1:]))
            i = j + 1
        elif tail[i].isdigit():
            m = re.match(r"\d+", tail[i:])
            i += m.end()
            args.append(tail[i:i + int(m.group())])
            i += int(m.group())
        else:
            args.append({"f": "float", "i": "int", "b": "bool"}.get(tail[i], tail[i]))
            i += 1
    return f"{name}<{','.join(args)}>"


# by source, the kernels that must run on the tensor cores and the HMMA
# each must show in its SASS: the f32 conv's and the MI forward's and
# backward's 3xTF32 run m16n8k8 TF32, the bf16 conv m16n8k16 bf16
# ------------------------------------------------- phase 15: data parallelism
PAR_WORLD = 2  # the gloo world on one card: two processes on cuda:0
PAR_STEPS = 3
PAR_AUG_SEED = 15  # every process's PBSpline generator: the same draws
# data-parallel against one process on the same card: the BatchNorm
# running statistics after the first update, whose forward both take from
# the same weights, differ by the sums' order alone: PAR_STEP1_RTOL (and
# PAR_STEP1_ATOL for a mean near 0), u and v likewise. After PAR_STEPS
# updates the weights differ within the Adam bar: Adam moves an element
# whose gradient is near 0 by about +-lr a step on rounding noise alone,
# differently in two runs that sum in another order, and the statistics of
# every later norm move with the weights (on an H100 80GB HBM3 at 700 W,
# phase 15 read up to 2.1e-3 on net_T's variances after 3 Rec steps and
# 1.1e-2 on net_G's after 3 Mixed steps, their step-0 losses equal to
# 1e-6). So the phase holds the parameters there, and each net's
# statistics of each kind (running means, variances, u, v) after
# PAR_STEPS to PAR_STATS_RTOL of the largest magnitude of that kind in
# the net: on the H100 80GB HBM3 at 700 W the largest share read 7.42e-3
# with the phase alone and 1.15e-2 in the whole script (net_G's means and
# variances after 3 Mixed updates; net_T's 9.81e-4-4.25e-3, u and v
# 1.63e-4-5.80e-4), 1.9e-4 on the CPU at tiny widths. No run of one
# process is a witness of that noise's size: a world of 1 sums the
# gradients as one process does, and read 12 to 28 times less than the
# world of 2 on some kinds on the card; rows in another order, or inputs
# off by rounding, read up to 1700 times less on the CPU
PAR_STEP1_RTOL = 1e-4
PAR_STEP1_ATOL = 1e-6
PAR_STATS_RTOL = 3e-2


def bn_followed_biases(model) -> set:
    """(net, JAX key) of the conv biases that a BatchNorm follows, whose
    exact gradient in train mode is 0: net_T's ConvBNAct convs, and every
    SNConv of net_G but the last (each feeds a BatchNorm through a sum or
    a concat)."""
    from spatialalignmentnetwork_tpu_torch.models.gan import SNConv
    from spatialalignmentnetwork_tpu_torch.models.unet_lib import ConvBNAct

    names = {("net_T", f"{n}.conv.bias") for n, m in model.net_T.named_modules()
             if isinstance(m, ConvBNAct)}
    snconvs = [n for n, m in model.net_G.named_modules() if isinstance(m, SNConv)]
    names |= {("net_G", f"{n}.conv.bias") for n in snconvs[:-1]}
    return {(net, j) for net in ("net_T", "net_G") for t, j, _, _ in model._entries(net)
            if (net, t) in names}


def stats_failures(got, want, rtol, atol):
    """The statistics (BatchNorm's, u and v) of entries `got` off `want` by
    more than rtol of the value plus atol; returns (failures, the largest
    relative difference as (value, net, key))."""
    fails, worst = [], (0.0, None, None)
    for name in want:
        for key, w in want[name].items():
            if not key.startswith("stats/"):
                continue
            w = np.asarray(w, np.float64)
            diff = np.abs(np.asarray(got[name][key], np.float64) - w)
            rel = float((diff / np.maximum(np.abs(w), 1e-30)).max())
            if rel >= worst[0]:
                worst = (rel, name, key)
            if not (diff <= atol + rtol * np.abs(w)).all():
                fails.append(f"{name} {key}: statistics {diff.max():.3g}")
    return fails, worst


def dp_failures(got, want, steps, lr, noise):
    """The parameters of checkpoint entries `got` ({net: {key: array}}) off
    `want` after `steps` Adam steps by more than the Adam bar (max |diff|
    < 2.5 lr steps, mean < 0.7 lr steps; the biases of `noise` the max
    alone). Returns (failures, the largest difference as (value, net,
    key))."""
    fails, worst = [], (0.0, None, None)
    for name in NETS:
        for key, w in want[name].items():
            if not key.startswith("params/"):
                continue
            diff = np.abs(np.asarray(got[name][key], np.float64) - np.asarray(w, np.float64))
            if diff.max() >= worst[0]:
                worst = (float(diff.max()), name, key)
            if diff.max() >= 2.5 * lr * steps:
                fails.append(f"{name} {key}: max {diff.max():.3g}")
            if (name, key) not in noise and diff.mean() >= 0.7 * lr * steps:
                fails.append(f"{name} {key}: mean {diff.mean():.3g}")
    return fails, worst


def stats_spread(got, want) -> dict:
    """The largest |got - want| over each net's running means, running
    variances and spectral-norm u and v, as a share of the largest |want|
    of that kind in that net: {(net, kind): share}."""
    diffs, scales = {}, {}
    for name in want:
        for key, w in want[name].items():
            if key.startswith("stats/"):
                nk = name, key.rsplit("/", 1)[1]
                w = np.asarray(w, np.float64)
                diff = float(np.abs(np.asarray(got[name][key], np.float64) - w).max())
                diffs[nk] = max(diffs.get(nk, 0.0), diff)
                scales[nk] = max(scales.get(nk, 0.0), float(np.abs(w).max()))
    return {nk: d / scales[nk] if scales[nk] else d for nk, d in diffs.items()}


def digest(entries) -> dict:
    """Each leaf's bytes, hashed: two ranks hold the same bits where these
    are equal."""
    import hashlib

    return {name: {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
                   for k, v in leaves.items()} for name, leaves in entries.items()}


def parallel_steps(p, reg, device, mesh=None):
    """PAR_STEPS updates of `reg` from the payload's weights and batches (in
    Mixed, PBSpline of the aug-size phantoms with PAR_AUG_SEED's draws,
    then the crop), on one process or, with `mesh`, each rank fed its rows
    of the same batches; launch counts
    reset just before and read just after. Returns the final entries, the
    BatchNorm statistics after the first update, the losses, the launches
    and ms a step (host clock over the steps, augmentation included)."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.parallel.mesh import shard_batch

    model = CSModel(cfg=p["cfg"][reg], device=device, seed=0)
    model.load_entries(p["entries"][reg])
    if mesh is not None:
        model.distribute(mesh)
    device = model.device
    gen = torch.Generator(device=device).manual_seed(PAR_AUG_SEED)
    shape = p["cfg"][reg].shape
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for full, aux in p["batches"][reg]:
        if reg == "Mixed":
            batch = augmented_batch(full, aux, gen, device, shape)
        else:
            batch = [torch.as_tensor(x, device=device) for x in (full, aux)]
        if mesh is not None:
            batch = [shard_batch(mesh, x) for x in batch]
        model.set_input(*batch)
        model.update()
        losses.append({k: float(v) for k, v in model._aux.items()})
        if len(losses) == 1:
            first = {name: {k: np.array(v) for k, v in entry.items() if k.startswith("stats/")}
                     for name, entry in model.checkpoint(NETS).items() if name in NETS}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3 / len(p["batches"][reg])
    launches = dict(kernels.LAUNCHES)
    entries = model.checkpoint(NETS)
    entries.pop("config")
    return {"entries": entries, "first": first, "losses": losses, "launches": launches,
            "ms": ms}


def parallel_eval(p, device, mesh=None):
    """`engine/eval.py::evaluate` over the payload's eval volumes (bucket
    EVAL_BUCKET) with its weights, alone or on a distributed model; launch
    counts reset just before and read just after."""
    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.eval import evaluate

    model = CSModel(cfg=serving_cfg(p["eval_shape"]), device=device, seed=0)
    model.load_entries(p["eval_entries"])
    model.eval()
    if mesh is not None:
        model.distribute(mesh)
    kernels.reset_launches()
    stats = evaluate(model, p["volumes"], p["bucket"])
    return {"stats": stats, "launches": dict(kernels.LAUNCHES)}


def _parallel_rank(rank, workdir, device):
    """One rank of phase 15's gloo world: the payload's Rec and Mixed steps
    and its eval on a distributed model, written to rank<r>.pkl."""
    import pickle

    import torch
    import torch.distributed as dist

    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision
    from spatialalignmentnetwork_tpu_torch.parallel.mesh import make_mesh

    f32_precision()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # two ranks on the CPU's cores, no oversubscription
    with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
        p = pickle.load(f)
    mesh = make_mesh(device=device, backend="gloo", rank=rank, world_size=PAR_WORLD,
                     init_method="file://" + os.path.join(workdir, "store"))
    try:
        out = {reg: parallel_steps(p, reg, device, mesh) for reg in ("Rec", "Mixed")}
        for step in out.values():
            step["digest"] = digest(step["entries"])
            if rank:
                del step["entries"]  # rank 0's bits stand for both
        out["eval"] = parallel_eval(p, device, mesh)
        out["peak_mib"] = (torch.cuda.max_memory_allocated(mesh.device) / 2**20
                           if mesh.device.type == "cuda" else 0.0)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def parallel_cli(rng, device, shape, batch, net_scale, slices, root):
    """15a: the train CLI (`engine/train.py::main`) on phase 12's phantom
    volumes, one Rec epoch from --seed 0, alone and through
    `--data_parallel`'s spawn path (one process a card: on one card a
    world of 1 over nccl; on the CPU one over gloo); the two final
    checkpoints leaf by leaf at the Adam bar (`dp_failures`)."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine import train
    from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    train_vols, val_vols = cli_volumes(rng, slices, shape)
    datasets = (cli_slices(train_vols), cli_slices(val_vols))
    steps = len(datasets[0]) // batch
    runs, finals, launches = {}, {}, {}
    for name, extra in (("alone", []), ("--data_parallel", ["--data_parallel"])):
        logdir = os.path.join(root, name.strip("-"))
        args = train.build_parser().parse_args(
            cli_argv(logdir, "Rec", "T1", shape, batch, net_scale, device) + extra)
        kernels.reset_launches()
        runs[name] = train.main(args, datasets)
        launches[name] = dict(kernels.LAUNCHES)
        if runs[name] is None or runs[name]["iter_cnt"] != steps:
            raise AssertionError(f"train CLI {name}: {runs[name] and runs[name]['iter_cnt']} "
                                 f"iterations, {steps} expected")
        finals[name] = ckpt_load(os.path.join(logdir, "ckpt", "ckpt_%010d.pt" % steps))
    model = CSModel(cfg=train.build_cfg(args), device="cpu")
    lr = float(model.cfg.lr)
    fails, worst = dp_failures(finals["--data_parallel"], finals["alone"], steps, lr,
                               bn_followed_biases(model))
    ms = {name: 1e3 * r["epochs"][0]["seconds"] / r["epochs"][0]["steps"]
          for name, r in runs.items()}
    psnr = {name: r["epochs"][0]["val"]["metric_PSNR"] for name, r in runs.items()}
    world = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    log(f"train CLI --data_parallel on {device} (spawned: a world of {world}) vs alone, "
        f"Rec, {steps} steps of {batch} at {shape}x{shape}: largest parameter difference "
        f"{worst[0]:.3g} ({worst[1]} {worst[2]}; the Adam bar {2.5 * lr * steps:.3g}); ms a "
        f"step (host clock, loader and augmentation included) {ms}; val PSNR {psnr}; "
        f"launches alone {launches['alone']}")
    if fails:
        raise AssertionError(f"train CLI --data_parallel vs alone: {fails}")


def check_parallel(rng, device="cuda", shape=SHAPE, batch=TRAIN_BATCH, net_scale="full",
                   slices=CLI_SLICES, workdir=None, eval_slices=EVAL_SLICES):
    """Phase 15, data parallelism (`parallel/mesh.py`, `CSModel.distribute`):

      a. the train CLI's `--data_parallel` spawn path (`parallel_cli`);
      b. a gloo world of PAR_WORLD processes on the one card (`device`),
         each fed its rows of the same global batch of `batch`: PAR_STEPS
         Rec updates at `shape` and PAR_STEPS Mixed updates (PBSpline 1.1
         `shape` -> `shape`), against the same steps of one process on
         the card from the same weights, batches and draws (`dp_failures`;
         the BatchNorm statistics after the first update at
         PAR_STEP1_RTOL; the statistics, u and v included, after the
         last within PAR_STATS_RTOL of the largest of their kind in the
         net; step 0's losses at LOSS_RTOL), both
         ranks' parameters and
         statistics the same bits, each rank's launch counts those of its
         steps (REC_LAUNCHES; MIXED_LAUNCHES and PBSPLINE_LAUNCHES);
      c. in the same world, `evaluate` of phase 11's volumes (drawn here,
         of `eval_slices` slices, when phase 11 did not run at `shape`) on
         the distributed model against it alone: per-volume PSNR within EVAL_PSNR_ATOL, the other scalars
         at the eval bars, both ranks alike, EVAL_LAUNCHES a volume.

    The gloo world's ms are a correctness run's: gloo stages every
    collective through the host. Prints the phase's seconds and peak
    device memory. Returns rank 0's launch counts of b and c. (The CPU
    tests run it at a small shape and tiny widths on the CPU, where no
    kernel launches.)"""
    import pickle

    import torch

    from spatialalignmentnetwork_tpu_torch.engine import train
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    t_phase = time.perf_counter()
    is_cuda = torch.device(device).type == "cuda"
    if is_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    root = workdir or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                   "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        parallel_cli(rng, device, shape, batch, net_scale, slices, os.path.join(root, "cli"))
        # b and c: one payload for every process
        aug = shape * 11 // 10
        p = {"cfg": {}, "entries": {}, "batches": {}, "bucket": EVAL_BUCKET}
        for reg in ("Rec", "Mixed"):
            cfg = train.build_cfg(train.build_parser().parse_args(
                cli_argv("-", reg, "T1", shape, batch, net_scale, device)))
            p["cfg"][reg] = cfg
            p["entries"][reg] = random_entries(CSModel(cfg=cfg, device="cpu", seed=0), rng,
                                               gan=reg == "Mixed")
            p["batches"][reg] = [phantoms(rng, batch, aug if reg == "Mixed" else shape)
                                 for _ in range(PAR_STEPS)]
        if "eval_inputs" not in MEASURED or MEASURED["eval_inputs"][2] != shape:
            model = CSModel(cfg=serving_cfg(shape), device="cpu", seed=0)
            MEASURED["eval_inputs"] = (random_entries(model, rng, gan=True),
                                       [eval_volume(rng, n, shape) for n in eval_slices],
                                       shape)
        p["eval_entries"], p["volumes"], p["eval_shape"] = MEASURED["eval_inputs"]
        with open(os.path.join(root, "payload.pkl"), "wb") as f:
            pickle.dump(p, f)
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_parallel_rank, args=(root, device), nprocs=PAR_WORLD)
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(PAR_WORLD):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        alone = {reg: parallel_steps(p, reg, device) for reg in ("Rec", "Mixed")}
        alone["eval"] = parallel_eval(p, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    model = CSModel(cfg=p["cfg"]["Mixed"], device="cpu", seed=0)
    noise = bn_followed_biases(model)
    lr = float(model.cfg.lr)
    want_launches = {"Rec": scaled(REC_LAUNCHES, PAR_STEPS),
                     "Mixed": scaled(add_counts(MIXED_LAUNCHES, PBSPLINE_LAUNCHES), PAR_STEPS),
                     "eval": scaled(EVAL_LAUNCHES, len(p["volumes"]))}
    for reg in ("Rec", "Mixed"):
        got, want = ranks[0][reg], alone[reg]
        fails, worst = dp_failures(got["entries"], want["entries"], PAR_STEPS, lr, noise)
        first_fails, first_worst = stats_failures(got["first"], want["first"], PAR_STEP1_RTOL,
                                                  PAR_STEP1_ATOL)
        fails += first_fails
        spread = stats_spread(got["entries"], want["entries"])
        fails += [f"{n} {k} after {PAR_STEPS} updates: {v:.3g} of its largest"
                  for (n, k), v in spread.items() if v > PAR_STATS_RTOL]
        if any(r[reg]["digest"] != got["digest"] for r in ranks):
            fails.append("the ranks' parameters or statistics differ in their bits")
        for k, v in want["losses"][0].items():
            if not abs(got["losses"][0][k] - v) <= LOSS_RTOL * abs(v) + 1e-6:
                fails.append(f"step 0 {k}: {got['losses'][0][k]} vs {v}")
        log(f"{reg} over a gloo world of {PAR_WORLD} on {device} (batch {batch} of "
            f"{shape}x{shape}, {batch // PAR_WORLD} rows a rank) vs one process: largest "
            f"parameter difference {worst[0]:.3g} ({worst[1]} {worst[2]}; the Adam bar "
            f"{2.5 * lr * PAR_STEPS:.3g}); BatchNorm statistics' largest relative difference "
            f"after the first update {first_worst[0]:.3g} ({first_worst[1]} {first_worst[2]}; "
            f"bar {PAR_STEP1_RTOL}); after {PAR_STEPS}, the largest difference a net and "
            f"kind as a share of its largest value (bar {PAR_STATS_RTOL}): "
            f"{ {f'{n} {k}': float(f'{v:.3g}') for (n, k), v in spread.items()} }"
            f"; step 0 losses {got['losses'][0]} vs "
            f"{want['losses'][0]}; ms a step {[r[reg]['ms'] for r in ranks]} (a "
            f"correctness run: gloo stages through the host) vs {want['ms']:.2f} alone; "
            f"launches a rank {[r[reg]['launches'] for r in ranks]}")
        if is_cuda:
            for r, rank in enumerate(ranks):
                if rank[reg]["launches"] != want_launches[reg]:
                    fails.append(f"rank {r} launches {rank[reg]['launches']}, expected "
                                 f"{want_launches[reg]}")
        if fails:
            raise AssertionError(f"{reg} data-parallel vs alone: {fails}")
    got, want = ranks[0]["eval"]["stats"], alone["eval"]["stats"]
    fails = [] if ranks[1]["eval"]["stats"] == got else ["the ranks' scalars differ"]
    for i, (g, w) in enumerate(zip(got, want)):
        for k, v in w.items():
            bar = (EVAL_PSNR_ATOL if k == "metric_PSNR" else EVAL_MI_ATOL if k == "metric_MI"
                   else EVAL_RTOL * abs(v))
            if not abs(g[k] - v) <= bar:
                fails.append(f"volume {i} {k}: {g[k]} vs {v} (bar {bar})")
    if is_cuda and any(r["eval"]["launches"] != want_launches["eval"] for r in ranks):
        fails.append(f"eval launches {[r['eval']['launches'] for r in ranks]}, expected "
                     f"{want_launches['eval']}")
    log(f"eval over a gloo world of {PAR_WORLD} on {device}: {len(got)} volumes of "
        f"{[len(v) for v in p['volumes']]} slices (bucket {p['bucket']}) vs one process: "
        f"|PSNR diff| {[abs(g['metric_PSNR'] - w['metric_PSNR']) for g, w in zip(got, want)]} "
        f"dB (bar {EVAL_PSNR_ATOL}); launches a rank {[r['eval']['launches'] for r in ranks]}")
    if fails:
        raise AssertionError(f"eval data-parallel vs alone: {fails}")
    log(f"data-parallel phase on {device}: {time.perf_counter() - t_phase:.1f} s (the gloo "
        f"world {world_s:.1f} s, process start included)"
        + (f", peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB in "
           f"this process, {[round(r['peak_mib'], 1) for r in ranks]} MiB in the ranks"
           if is_cuda else ""))
    return add_counts(ranks[0]["Rec"]["launches"], ranks[0]["Mixed"]["launches"],
                      ranks[0]["eval"]["launches"])


HMMA = {"conv.cu": {"conv3x3_tf32_kernel": "HMMA.1688.F32.TF32",
                    "conv3x3_bf16_kernel": "HMMA.16816.F32.BF16"},
        "mi.cu": {"mi_fwd_gram_kernel": "HMMA.1688.F32.TF32",
                  "mi_bwd_pixel_kernel": "HMMA.1688.F32.TF32"}}
# sources whose every kernel of the stem is one HMMA names: no conv kernel
# off the tensor cores
TENSOR_CORES_ONLY = {"conv.cu": "conv3x3"}
# sources held to the build check: the HMMA ones, the window losses' and
# the grid sample's (no HMMA required, no spill allowed)
BUILD_CHECKED = (*HMMA, "lncc.cu", "ssim.cu", "grid_sample.cu")


# --------------------------------------------------- phase 16: library and tooling
EXPORT_OP = "san.grid_sample_fwd.default"
# the replay against the live path: the same aten operations and kernel on
# the same inputs (as the examples' rtol 1e-5, atol 1e-6), atol a fraction
# of max |live|
EXPORT_RTOL = 1e-5
EXPORT_ATOL_REL = 1e-6
EXPORT_SERVE_LINE = "reloaded artifact matches the live serving path"
# the allocator's first subprocess: take the host lock, make the card it
# is given (this process's first visible one) the only visible one,
# reconstruct, report, and hold the lock until told
AUTOGPU_HOLDER = """
import json, sys
import numpy as np
from spatialalignmentnetwork_tpu_torch.utils.autogpu import auto_gpu
lock = auto_gpu(sys.argv[2], exclusive=True)
import torch
import chip_smoke
from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
model = CSModel(cfg=chip_smoke.serving_cfg(int(sys.argv[1])))
full, aux = chip_smoke.phantoms(np.random.default_rng(0), 1, int(sys.argv[1]))
out = model.reconstruct(full, aux)
print(json.dumps({"count": torch.cuda.device_count(), "visible": __import__("os").environ[
    "CUDA_VISIBLE_DEVICES"], "finite": bool(torch.isfinite(out).all()),
    "launches": dict(kernels.LAUNCHES)}), flush=True)
sys.stdin.readline()
lock.release()
"""
AUTOGPU_TAKER = """
from spatialalignmentnetwork_tpu_torch.utils.autogpu import Locker
print(Locker().acquire(blocking=False), flush=True)
"""
# seconds the holder may take to take the lock, build its model and report
AUTOGPU_HOLDER_S = 300


def repo_env():
    """The environment of a subprocess that imports the repo's modules."""
    root = os.path.dirname(os.path.abspath(__file__))
    return root, {**os.environ, "PYTHONPATH": root}


def program_targets(module):
    return [str(n.target) for n in module.graph.nodes if n.op == "call_function"]


def time_requests(fn, full, aux):
    """ms a request of fn(full, aux) on the card: CUDA events around
    TIMED_REQUESTS calls after WARMUP_REQUESTS."""
    import torch

    with torch.inference_mode():
        for _ in range(WARMUP_REQUESTS):
            fn(full, aux)
        torch.cuda.synchronize()
        with cuda_timer() as timer:
            for _ in range(TIMED_REQUESTS):
                fn(full, aux)
    return timer.secs * 1e3 / TIMED_REQUESTS


def check_export(rng):
    """Phase 16, library and tooling:

      a. export on the card: a `CSModel` at the default widths (SHAPE),
         weights from the seed with a non-zero STN head (`random_entries`),
         exported at BATCH
         (`engine/export.py`) and reloaded from the bytes; its graph holds
         the custom op `san::grid_sample_fwd` once and no aten grid
         sampler; the replay against live `reconstruct` within EXPORT_RTOL
         and EXPORT_ATOL_REL x max|live|; one replayed call launches
         grid_sample_fwd once (counts reset just before, read just after);
         the export's seconds, the artifact's bytes and ms a request of the
         replay beside live's (CUDA events, TIMED after WARMUP requests);
      b. examples/torch_serve.py --resume on a's model saved, in a fresh
         process on the default device: exit 0 and its match line;
      c. the profiler (`utils/profiler.py`'s main at SHAPE, --repeat 5):
         the four nets' parameter counts those of the same nets on the CPU,
         their counted FLOPs `analytic_flops` of `utils/flops.py`; `trace`
         around one `reconstruct` writes a trace naming the forward kernel
         (launches counted as in a);
      d. the allocator: the host lock must be free; a subprocess takes
         `auto_gpu(<this process's first visible card>, exclusive=True)`
         and reconstructs, seeing that one card (its report awaited at
         most AUTOGPU_HOLDER_S); a second subprocess's non-blocking
         `Locker.acquire` fails while the first holds the lock, and this
         process's succeeds after.

    Prints the phase's seconds; writes its checkpoint under the gitignored
    build/export/ and removes it. Returns the launch counts of the
    replayed call and the traced reconstruct."""
    import torch

    from spatialalignmentnetwork_tpu_torch import kernels
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
    from spatialalignmentnetwork_tpu_torch.engine.export import (
        export_reconstruct, load_exported,
    )
    from spatialalignmentnetwork_tpu_torch.utils import autogpu, profiler

    t_phase = time.perf_counter()
    # the earlier phases' cached blocks would leave the subprocesses of b
    # and d no device memory
    free_card()
    root, env = repo_env()
    shape, batch = SHAPE, BATCH
    work = os.path.join(root, "build", "export")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counts = {}
    try:
        # a. export on the card
        model = CSModel(cfg=serving_cfg(shape), device="cuda", seed=0)
        model.load_entries(random_entries(model, rng))
        full, aux = (torch.as_tensor(x, device=model.device)
                     for x in phantoms(rng, batch, shape))
        t0 = time.perf_counter()
        blob = export_reconstruct(model, tuple(full.shape))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replay = load_exported(blob)
        load_s = time.perf_counter() - t0
        targets = program_targets(replay)
        if targets.count(EXPORT_OP) != 1 or [t for t in targets if "grid_sampler" in t]:
            raise AssertionError(f"the exported graph samples through "
                                 f"{[t for t in targets if 'grid' in t]}")
        live = model.reconstruct(full, aux)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with torch.inference_mode():
            got = replay(full, aux)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if launches != {"grid_sample_fwd": 1}:
            raise AssertionError(f"one replayed request launched {launches}")
        counts = add_counts(counts, launches)
        scale = float(live.abs().max())
        err = float((got - live).abs().max())
        torch.testing.assert_close(got, live, rtol=EXPORT_RTOL, atol=EXPORT_ATOL_REL * scale)
        live_ms = time_requests(model.reconstruct, full, aux)
        replay_ms = time_requests(replay, full, aux)
        log(f"export on {model.device}: [{batch},1,{shape},{shape}] traced and serialized "
            f"in {export_s:.2f} s, {len(blob)} bytes, reloaded in {load_s:.2f} s; "
            f"{targets.count(EXPORT_OP)} {EXPORT_OP} node of {len(targets)} calls; replay vs live max|diff| {err:.3g} (max|live| "
            f"{scale:.4g}); one replayed request launched {launches}; ms a request: "
            f"replay {replay_ms:.3f}, live {live_ms:.3f} ({replay_ms / live_ms:.4f}x)")
        MEASURED["export"] = {"replay_ms": replay_ms, "live_ms": live_ms, "bytes": len(blob),
                              "export_s": export_s}
        ckpt = os.path.join(work, "model")
        model.save(ckpt)

        # b. the serving example in a fresh process
        free_card()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, os.path.join(root, "examples", "torch_serve.py"), "--resume",
             ckpt, "--batch", str(batch)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0 or EXPORT_SERVE_LINE not in out.stdout:
            raise AssertionError(f"examples/torch_serve.py exited {out.returncode}:\n"
                                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        log(f"examples/torch_serve.py --resume --batch {batch}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s (this process holding "
            f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB): "
            + " | ".join(ln for ln in out.stdout.splitlines() if not ln.startswith("Namespace")))

        # c. the profiler
        rows = profiler.main(["--shape", str(shape), "--repeat", "5"])
        cpu_params = {name: profiler.param_count(module)
                      for name, module, _ in profiler.nets(32, 1, "cpu")}
        want_flops = profiler.analytic_flops(shape)
        for name, params, flops, _ in rows:
            if params != cpu_params[name] or flops != want_flops[name]:
                raise AssertionError(f"{name}: {params} parameters (CPU {cpu_params[name]}), "
                                     f"{flops} FLOPs (utils/flops.py {want_flops[name]})")
        MEASURED["profiler"] = rows
        logdir = os.path.join(work, "trace")
        kernels.reset_launches()
        with profiler.trace(logdir):
            model.reconstruct(full, aux)
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        counts = add_counts(counts, launches)
        (name,) = os.listdir(logdir)
        with open(os.path.join(logdir, name)) as f:
            text = f.read()
        if "grid_sample_fwd_kernel" not in text:
            raise AssertionError(f"the trace {name} names no grid_sample_fwd_kernel")
        log(f"profiler on {model.device}: parameters and FLOPs as the CPU's and "
            f"utils/flops.py's; trace {name} ({len(text)} bytes) names "
            f"grid_sample_fwd_kernel {text.count('grid_sample_fwd_kernel')} time(s); "
            f"launches {launches}")
        del model, replay, live, got
        free_card()

        # d. the allocator
        lock_path = autogpu.LOCK_PATH
        mine = autogpu.Locker()
        if not mine.acquire(blocking=False):
            raise AssertionError(f"{lock_path} is held by another process on this host")
        mine.release()
        card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        holder = subprocess.Popen(
            [sys.executable, "-c", AUTOGPU_HOLDER, str(shape), card], cwd=root,
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            ready, _, _ = select.select([holder.stdout], [], [], AUTOGPU_HOLDER_S)
            if not ready:
                raise AssertionError(f"the auto_gpu holder reported nothing in "
                                     f"{AUTOGPU_HOLDER_S} s")
            line = holder.stdout.readline()
            if not line:
                raise AssertionError(f"the auto_gpu holder died: {holder.stderr.read()[-3000:]}")
            held = json.loads(line)
            taker = subprocess.run([sys.executable, "-c", AUTOGPU_TAKER], cwd=root, env=env,
                                   capture_output=True, text=True, timeout=120)
            if taker.returncode != 0 or taker.stdout.strip() != "False":
                raise AssertionError(f"the second Locker took {lock_path} while it was held: "
                                     f"{taker.stdout}{taker.stderr[-2000:]}")
            holder.stdin.write("\n")
            holder.stdin.flush()
            if holder.wait(timeout=120) != 0:
                raise AssertionError(f"the auto_gpu holder exited {holder.returncode}")
        finally:
            if holder.poll() is None:
                holder.kill()
                holder.wait()
        if (not held["finite"] or held["visible"] != card or held["count"] != 1
                or held["launches"] != {"grid_sample_fwd": 1}):
            raise AssertionError(f"under auto_gpu: {held}")
        if not mine.acquire(blocking=False):
            raise AssertionError(f"{lock_path} stayed locked after its holder exited")
        mine.release()
        log(f"auto_gpu({card!r}, exclusive=True): {held}; a second non-blocking Locker "
            f"refused while held, then this process took {lock_path}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 16 (library and tooling): {time.perf_counter() - t_phase:.1f} s")
    return counts


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


GRID_SHAPES = ((TRAIN_BATCH, 1, SHAPE, SHAPE), (TRAIN_BATCH, 2, SHAPE, SHAPE),
               (TRAIN_BATCH, 1, SHAPE // 2, SHAPE // 2))


def grid_phases(checks=True, bits_file=None):
    """The grid sample kernels' phases alone: the build check of
    grid_sample.cu (each kernel's registers and spills), with `checks` the
    forward and both backwards against their plain versions
    (check_grid_sample, check_grid_sample_bwd), the backwards' times at
    GRID_SHAPES with each launch's device us and launches a call
    (torch.profiler), and with `bits_file` d_grid's bits written to or held
    to that file (dgrid_bits). From a parent tree, with this file copied
    in, run `grid_phases(False, ...)`: its d_img need not pass the checks.
    Returns the process's exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    log(f"card: {nvidia_smi()}")
    check_build("grid_sample.cu", *build_kernels(["grid_sample.cu"])["grid_sample.cu"])
    rng = np.random.default_rng(0)
    if checks:
        for e in (check_grid_sample(rng), *check_grid_sample_bwd(rng)):
            log(json.dumps(e))
    if bits_file:
        dgrid_bits(bits_file)
    for shape in GRID_SHAPES:
        time_grid_bwd(rng, shape)
        profile_grid(shape)
    return 0


def eval_phases():
    """The eval phase alone: build the grid sample and SSIM kernels (the
    eval step's), then `check_eval`. 0 when it passes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(["grid_sample.cu", "ssim.cu"])
    check_eval(np.random.default_rng(0))
    return 0


def train_cli_phases():
    """Phase 12 alone, after phase 10's timed Mixed steps (`check_mixed`)
    for the step time it prints beside the CLI's: build the grid sample and
    SSIM kernels, then `check_mixed` and `check_train_cli`. 0 when they
    pass."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(["grid_sample.cu", "ssim.cu"])
    rng = np.random.default_rng(0)
    check_mixed(rng)
    check_train_cli(rng)
    return 0


def mask_phases():
    """Phase 13 alone: build the grid sample and SSIM kernels (the steps'),
    then `check_masks`. 0 when it passes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(["grid_sample.cu", "ssim.cu"])
    check_masks(np.random.default_rng(0))
    return 0


def precision_phases():
    """Phase 14 alone: build the grid sample and SSIM kernels (the paths'),
    then `check_precision`. 0 when it passes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(["grid_sample.cu", "ssim.cu"])
    check_precision(np.random.default_rng(0))
    return 0


def parallel_phases():
    """Phase 15 alone: build the grid sample and SSIM kernels (the steps'
    and eval's), then `check_parallel`. 0 when it passes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(["grid_sample.cu", "ssim.cu"])
    check_parallel(np.random.default_rng(0))
    return 0


def export_phases():
    """Phase 16 alone: build the grid sample kernel (the serving path's),
    then `check_export`. 0 when it passes."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import f32_precision

    f32_precision()
    log(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels(["grid_sample.cu"])
    check_export(np.random.default_rng(0))
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
    # the GAN phases draw from the generator after every earlier phase, so
    # that those keep the inputs they had before the GAN phases existed
    mixed = check_mixed(rng)
    main_paths.append(mixed)
    check_gan_only_and_accum(rng)
    check_augment(rng)
    check_train_vs_cpu(rng, reg="Mixed")
    main_paths.append(check_eval(rng))  # draws after every earlier phase
    cli = check_train_cli(rng)  # draws after every earlier phase
    main_paths.append(cli)
    masks = check_masks(rng)  # draws after every earlier phase
    main_paths.append(masks)
    precision = check_precision(rng)  # draws after every earlier phase
    main_paths.append(precision)
    parallel = check_parallel(rng)  # draws after every earlier phase
    main_paths.append(parallel)
    main_paths.append(check_export(rng))  # draws after every earlier phase
    for e in entries:
        # serving, the Rec and Mixed train steps, eval, the train CLI's
        # Proposed stage, mask learning, the precision phase, data
        # parallelism and the exported serving program are the main paths
        # (d_img runs on the Mixed ones, and on its own); the
        # loss kernels run on the registration-loss library's entry points,
        # the conv on its own entry point's ladder
        if e["name"] == "grid_sample_bwd_dimg":
            paths = [autograd, mixed, cli, masks, precision, parallel]
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
