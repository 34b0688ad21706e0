"""spatialalignmentnetwork_tpu_torch — PyTorch/CUDA port of the
spatial-alignment-assisted MRI reconstruction system, for NVIDIA Hopper.

The JAX package `spatialalignmentnetwork_tpu` is the reference; this
package mirrors its module layout so each counterpart is easy to find, and
imports none of it (nor JAX). Plain tensor code is PyTorch; every Pallas
TPU kernel on a ported path is a hand-written CUDA kernel under `csrc/`,
built at first use and bound through `kernels/`.

Layout:
    ops/       fft/rss, k-space masks, grid sampling, window sums, the
               SSIM loss and the LNCC and MI registration losses, center
               crop, bicubic resize
    models/    VarNet + NormUnet, spatial transformer, LibUNet (and the
               Encoder, Decoder and ResNet factories), the GAN's
               spectral-norm NetG and NetD
    data/      augmentation (rigid + B-spline, the four batch policies),
               the paired h5 volume datasets
    utils/     the eval metrics, on tensors (`metrics_torch`) and in numpy
    kernels/   ctypes bindings of the CUDA kernels, launch counts; the 3x3
               conv entry point `kernels.conv.conv3x3_s2d` and its op
               `san::conv3x3`, which net_R's U-Net convs take in true f32
               on the card
    csrc/      CUDA C++ sources (sm_90a)
    engine/    Config, checkpoints (the JAX package's and the
               reference's layouts), weight carry-over from the JAX
               package's checkpoints, the CSModel (serving, the four train
               regimes, the eval step), the eval CLI
"""

__version__ = "0.1.0"
