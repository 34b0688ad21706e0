"""The PyTorch port's 3x3 conv (`kernels/conv.py::conv3x3_s2d`) against the
JAX package's Pallas kernel (`ops/pallas/conv.py::conv3x3_s2d`) in
interpret mode, on the CPU, where the port takes its plain version.

Inputs come from numpy seeds. Tolerances:
  * f32 forward and gradients: rtol 1e-4, atol 1e-5 (of the gradient's max
    |value| for the gradients): the same products, summed in another
    order (the JAX kernel as a space-to-depth 2x2 GEMM);
  * bf16 forward: one bf16 ulp of the larger of the two values: both round
    one f32 sum once, and the order of that sum may flip the last bit.
"""

import contextlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spatialalignmentnetwork_tpu.ops.pallas.conv import conv3x3_s2d as jconv

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv
from spatialalignmentnetwork_tpu_torch.models.layers import ConvBlock

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol_of_max=1e-5)

# (N, H, W, Cin, Cout): the JAX package's own two cases
# (tests/test_pallas.py:256), the first conv of a cascade (Cin 3), and a
# two-channel output (the input gradient of the sensitivity net's first conv)
SHAPES = {
    "2x16x16_18to18": (2, 16, 16, 18, 18),
    "1x40x24_4to8": (1, 40, 24, 4, 8),
    "2x16x16_3to18": (2, 16, 16, 3, 18),
    "1x8x8_18to2": (1, 8, 8, 18, 2),
}


def _inputs(shape, seed):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return x, k, cot


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_forward_f32_matches_pallas(case):
    x, k, _ = _inputs(SHAPES[case], 30)
    want = np.asarray(jconv(jnp.asarray(x), jnp.asarray(k), True))
    got = kconv.conv3x3_s2d(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_forward_bf16_within_one_ulp_of_pallas(case):
    x, k, _ = _inputs(SHAPES[case], 31)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    want = jconv(xb, kb, True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = kconv.conv3x3_s2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.maximum(_bf16_ulp(got), _bf16_ulp(want))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))
    # an f32 w3 is rounded to x's dtype first, as the JAX kernel does
    got32w = kconv.conv3x3_s2d(torch.from_numpy(x).bfloat16(), torch.from_numpy(k))
    assert torch.equal(got32w.float(), torch.from_numpy(got))


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_gradients_f32_match_pallas_vjp(case):
    x, k, cot = _inputs(SHAPES[case], 32)
    jcot = jnp.asarray(cot)
    want = jax.grad(lambda a, b: jnp.sum(jconv(a, b, True) * jcot), (0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    (kconv.conv3x3_s2d(tx, tk) * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((tx.grad, tk.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=GRAD["rtol"],
                                   atol=GRAD["atol_of_max"] * float(np.abs(w).max()))
    # dx is the forward conv of the cotangent with the rotated weights
    dx = kconv.conv3x3_plain(torch.from_numpy(cot), kconv.rotate(torch.from_numpy(k)))
    assert torch.equal(tx.grad, dx)


def test_bf16_backward_is_refused_as_in_the_reference():
    """The JAX VJP raises TypeError in bf16 (ops/pallas/conv.py:164-171
    convolves the bf16 x with the f32 cotangent); the port raises
    NotImplementedError rather than add a feature the reference lacks."""
    x, k, _ = _inputs(SHAPES["1x8x8_18to2"], 33)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.grad(lambda a, b: jnp.sum(jconv(a, b, True).astype(jnp.float32)),
                 (0, 1))(xb, kb)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tk = torch.from_numpy(k).bfloat16().requires_grad_()
    out = kconv.conv3x3_s2d(tx, tk)
    assert out.dtype == torch.bfloat16  # the forward works, as in JAX
    with pytest.raises(NotImplementedError, match="conv.py:164-171"):
        out.float().sum().backward()


@pytest.mark.parametrize("hw", [(5, 4), (4, 5)])
def test_odd_height_or_width_is_refused_by_both(hw):
    x = np.zeros((1, *hw, 2), np.float32)
    k = np.zeros((3, 3, 2, 2), np.float32)
    with pytest.raises(AssertionError, match="even H, W"):
        jconv(jnp.asarray(x), jnp.asarray(k), True)
    with pytest.raises(ValueError, match="even H and W"):
        kconv.conv3x3_s2d(torch.from_numpy(x), torch.from_numpy(k))


def test_mocked_card_route_keeps_the_gradient(monkeypatch):
    """The card's route through the custom op `san::conv3x3`, with the CUDA
    wrapper standing in as the plain version: the forward and the input
    gradient each call the wrapper once, the output keeps the op's
    registered backward as its grad_fn, and the weight gradient is the
    library's backward-filter,
    run with cuDNN's TF32 off whatever the caller set."""
    calls = []

    def standin(x, w3):
        calls.append((tuple(x.shape), tuple(w3.shape)))
        return kconv.conv3x3_plain(x, w3)

    tf32_seen = []
    library = torch.nn.grad.conv2d_weight

    def spy(*args, **kwargs):
        tf32_seen.append(torch.backends.cudnn.allow_tf32)
        return library(*args, **kwargs)

    monkeypatch.setattr(kconv, "on_card", lambda t: True)
    monkeypatch.setattr(kconv, "conv3x3_cuda", standin)
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x, k, cot = _inputs((2, 8, 12, 3, 5), 34)
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    out = kconv.conv3x3_s2d(tx, tk)
    assert type(out.grad_fn).__name__ == "GeneratedBackwardFor_san_conv3x3_defaultBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == [((2, 8, 12, 3), (3, 3, 3, 5)), ((2, 8, 12, 5), (3, 3, 5, 3))]
    assert tf32_seen == [False] and torch.backends.cudnn.allow_tf32 is True
    want_dw = library(tx.detach().permute(0, 3, 1, 2), (5, 3, 3, 3),
                      torch.from_numpy(cot).permute(0, 3, 1, 2), padding=1)
    assert torch.equal(tk.grad, want_dw.permute(2, 3, 1, 0))


def test_wrapper_raises_without_launching(monkeypatch):
    launched = []
    monkeypatch.setattr(kconv, "_launcher", lambda: launched.append(1))
    kernels.reset_launches()
    x = torch.rand((1, 4, 4, 3))
    w = torch.rand((3, 3, 3, 2))
    with pytest.raises(TypeError):  # f32 or bf16 only
        kconv.conv3x3_cuda(x.double(), w.double())
    with pytest.raises(TypeError):  # one dtype for both
        kconv.conv3x3_cuda(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        kconv.conv3x3_cuda(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="CUDA"):  # CPU tensors never reach the kernel
        kconv.conv3x3_cuda(x, w)
    for bad_x, bad_w in ((torch.rand((1, 4, 4, 2)), w),       # Cin mismatch
                         (torch.rand((1, 3, 4, 3)), w),       # odd H
                         (x, torch.rand((2, 3, 3, 2))),       # not 3x3
                         (x[0], w)):                          # not NHWC
        with pytest.raises(ValueError):
            kconv.conv3x3_cuda(bad_x, bad_w)
        with pytest.raises(ValueError):
            kconv.conv3x3_s2d(bad_x, bad_w)
    with pytest.raises(TypeError):
        kconv.conv3x3_s2d(x.double(), w.double())
    assert launched == [] and not kernels.LAUNCHES


def test_mocked_launch_routes_by_dtype_and_counts(monkeypatch):
    """A CUDA-tagged call reaches the C entry point with its pointers, the
    shape and the dtype flag (1: the bf16 kernel, 0: the f32 3xTF32
    kernel) on the tensor's stream, and counts one launch under that
    kernel's name; a failed launch raises and counts nothing."""
    calls = []
    rc = [0]

    def launcher(*args):
        calls.append(args)
        return rc[0]

    monkeypatch.setattr(kconv, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(kconv, "_launcher", lambda: launcher)
    kernels.reset_launches()
    for dtype, flag, name in ((torch.bfloat16, 1, kconv.NAME_BF16),
                              (torch.float32, 0, kconv.NAME)):
        x = torch.rand((2, 6, 4, 18)).to(dtype)
        w = torch.rand((3, 3, 18, 3)).to(dtype)
        out = kconv.conv3x3_cuda(x, w)
        assert out.shape == (2, 6, 4, 3) and out.dtype == dtype
        assert calls[-1] == (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             2, 6, 4, 18, 3, flag, 1234)
        assert kernels.LAUNCHES[name] == 1
    assert dict(kernels.LAUNCHES) == {kconv.NAME: 1, kconv.NAME_BF16: 1}
    rc[0] = 700  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="conv3x3_bf16 kernel launch failed"):
        kconv.conv3x3_cuda(x.bfloat16(), w.bfloat16())
    assert dict(kernels.LAUNCHES) == {kconv.NAME: 1, kconv.NAME_BF16: 1}
    # the entry point's forward in bf16 takes the same launch (no backward)
    rc[0] = 0
    kconv.conv3x3_s2d(x.bfloat16(), w)
    assert calls[-1][8] == 1 and kernels.LAUNCHES[kconv.NAME_BF16] == 2
    kernels.reset_launches()


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.parametrize("in_chans,chans", [(3, 18), (2, 8)])
def test_chip_smoke_ladder_is_the_unets_3x3_convs(in_chans, chans):
    """The conv ladder chip_smoke.py drives is every 3x3 conv of the port's
    U-Net (a cascade's: 3 inputs, 18 channels; the sensitivity net's: 2
    inputs, 8 channels; 4 pools), in the order a forward runs them,
    recorded here by hooks on a 32x32 forward."""
    from spatialalignmentnetwork_tpu_torch.models.unet import Unet

    seen = []
    net = Unet(in_chans, 2, chans, 4)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3):
            m.register_forward_hook(
                lambda m, i, o: seen.append((i[0].shape[-1], m.in_channels, m.out_channels)))
    with torch.no_grad():
        net(torch.zeros((1, in_chans, 32, 32)))
    assert _chip_smoke().unet_convs(in_chans, chans, 4, 32) == seen
    assert len(seen) == 18 and len(set(seen)) == 14


def test_chip_smoke_conv_build_check_reads_hmma_and_spills(monkeypatch):
    """chip_smoke.py's check of the built conv and MI libraries, on made-up
    ptxas logs and cuobjdump listings: it names each kernel from its
    mangled name, counts each kernel's HMMA of its type (TF32 in the f32
    conv kernel, the MI forward's Gram kernel and the MI backward's pixel
    kernel, bf16 in the bf16 conv kernel) and fails on a kernel of either
    type without them, or on any kernel with spills."""
    import subprocess

    cs = _chip_smoke()
    bf = "_ZN12_GLOBAL__N_119conv3x3_bf16_kernelILi16ELi16ELi8ELi1ELi3EEEvPK13__nv_bfloat16"
    f32 = "_ZN12_GLOBAL__N_119conv3x3_tf32_kernelILi8ELi16ELi4ELi1ELi9EEEvPKfS2_Pfiiiiiiiii"

    def ptxas(spill_bf, spill_f32):
        return "\n".join(
            f"ptxas info    : Function properties for {fn}\n"
            f"    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads\n"
            f"ptxas info    : Used {r} registers, used 1 barriers"
            for fn, r, s in ((bf, 80, spill_bf), (f32, 168, spill_f32)))

    def sass(hmma_bf, hmma_f32):
        return "\n".join(
            f"\t\tFunction : {fn}\n" + f"        /*0010*/ {op} R4, R8, R12, R4 ;\n" * n
            + "        /*0020*/ FFMA R1, R2, R3, R1 ;"
            for fn, op, n in ((bf, "HMMA.16816.F32.BF16", hmma_bf),
                              (f32, "HMMA.1688.F32.TF32", hmma_f32)))

    monkeypatch.setattr(kernels, "_nvcc", lambda: "/cuda/bin/nvcc")
    # (bf16 spill, f32 spill, bf16 HMMA, f32 HMMA, passes): both right; a
    # bf16 spill; bf16 without HMMA; f32 without HMMA; an f32 spill
    for spill_bf, spill_f32, hb, hf, ok in ((0, 0, 54, 162, True), (8, 0, 54, 162, False),
                                            (0, 0, 0, 162, False), (0, 0, 54, 0, False),
                                            (0, 16, 54, 162, False)):
        monkeypatch.setattr(subprocess, "run", lambda cmd, _s=sass(hb, hf), **kw:
                            subprocess.CompletedProcess(cmd, 0, _s, ""))
        if ok:
            got = cs.check_build("conv.cu", "libconv.so", ptxas(spill_bf, spill_f32))
            assert got == {"conv3x3_bf16_kernel<16,16,8,1,3>":
                           {"spill": 0, "registers": 80, "hmma": 54},
                           "conv3x3_tf32_kernel<8,16,4,1,9>":
                           {"spill": 0, "registers": 168, "hmma": 162}}
        else:
            with pytest.raises(AssertionError, match="HMMA or spills"):
                cs.check_build("conv.cu", "libconv.so", ptxas(spill_bf, spill_f32))
    # the f32 kernel's HMMA must be TF32 ones: bf16 HMMA there do not count
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 0, sass(54, 0).replace(f"{f32}\n", f"{f32}\n        /*0010*/ "
                                    "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"), ""))
    with pytest.raises(AssertionError, match="HMMA or spills"):
        cs.check_build("conv.cu", "libconv.so", ptxas(0, 0))

    # mi.cu: the forward's Gram kernel and the backward's pixel kernel must
    # show TF32 HMMA (3xTF32); no kernel of the source may spill, the FFMA
    # ones included. The names as nvcc 12.8 mangles them, the anonymous
    # namespace named after the file
    mi = {name: f"_ZN37_GLOBAL__N__4ff34e87_5_mi_cu_70cd0373{len(name)}{name}EPKfS1_Pflf"
          for name in ("mi_fwd_gram_kernel", "mi_fwd_reduce_kernel", "mi_bwd_coef_kernel",
                       "mi_bwd_pixel_kernel")}

    def mi_ptxas(spill_coef):
        return "\n".join(
            f"ptxas info    : Function properties for {fn}\n"
            f"    0 bytes stack frame, {s} bytes spill stores, {s} bytes spill loads\n"
            f"ptxas info    : Used {r} registers, used 1 barriers"
            for fn, r, s in ((mi["mi_fwd_gram_kernel"], 125, 0),
                             (mi["mi_fwd_reduce_kernel"], 29, 0),
                             (mi["mi_bwd_coef_kernel"], 32, spill_coef),
                             (mi["mi_bwd_pixel_kernel"], 120, 0)))

    def mi_sass(op, on=("gram", "pixel")):
        return "\n".join(
            f"\t\tFunction : {fn}\n" + (f"        /*0010*/ {op} R4, R8, R12, R4 ;\n" * 48
                                        if any(k in fn for k in on) else "")
            + "        /*0020*/ FFMA R1, R2, R3, R1 ;" for fn in mi.values())

    # (coef spill, HMMA type, kernels with it, passes): right; a spill in an
    # FFMA kernel; bf16 HMMA where TF32 ones are required; the forward's
    # Gram kernel without HMMA; the backward's pixel kernel without them
    for spill, op, on, ok in ((0, "HMMA.1688.F32.TF32", ("gram", "pixel"), True),
                              (8, "HMMA.1688.F32.TF32", ("gram", "pixel"), False),
                              (0, "HMMA.16816.F32.BF16", ("gram", "pixel"), False),
                              (0, "HMMA.1688.F32.TF32", ("pixel",), False),
                              (0, "HMMA.1688.F32.TF32", ("gram",), False)):
        monkeypatch.setattr(subprocess, "run", lambda cmd, _s=mi_sass(op, on), **kw:
                            subprocess.CompletedProcess(cmd, 0, _s, ""))
        if ok:
            assert cs.check_build("mi.cu", "libmi.so", mi_ptxas(spill)) == {
                "mi_fwd_gram_kernel": {"spill": 0, "registers": 125, "hmma": 48},
                "mi_fwd_reduce_kernel": {"spill": 0, "registers": 29, "hmma": 0},
                "mi_bwd_coef_kernel": {"spill": 0, "registers": 32, "hmma": 0},
                "mi_bwd_pixel_kernel": {"spill": 0, "registers": 120, "hmma": 48}}
        else:
            with pytest.raises(AssertionError, match="HMMA or spills"):
                cs.check_build("mi.cu", "libmi.so", mi_ptxas(spill))


def _tf32(v):
    """float32 v rounded to TF32 as `cvt.rna.tf32.f32` rounds it: 10
    mantissa bits, ties away from zero (half the weight of the 13 dropped
    bits added to the magnitude, then the bits dropped)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32's spacing at 1
    v = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23, 1 + 1.5 * ulp, 3.0],
                 np.float32)
    assert _tf32(v).tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0]


@pytest.mark.parametrize("shape", [(1, 20, 20, 288, 288), (1, 10, 10, 576, 288)],
                         ids=["20x20_288to288", "10x10_576to288"])
def test_3xtf32_emulation_meets_the_f32_bar_and_tf32_misses_it(shape):
    """The f32 kernel's arithmetic (csrc/conv.cu, 3xTF32), emulated on the
    CPU at the ladder's deepest conv and at CONV_EDGES' K = 5184: each f32
    operand split into hi = tf32(v) and lo = tf32(v - hi), each tap's
    products as lo.hi + hi.lo + hi.hi (every product of two TF32 values is
    exact in f32), summed in f32. It lands within chip_smoke.CONV_TOL of
    max of float64, the bar the kernel is held to on the card; plain TF32
    (hi.hi alone) misses that bar on the same inputs."""
    cs = _chip_smoke()
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(40)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    xh, kh = _tf32(x), _tf32(k)
    xl, kl = _tf32(x - xh), _tf32(k - kh)
    pad = lambda a: torch.nn.functional.pad(torch.from_numpy(a), (0, 0, 1, 1, 1, 1))
    xh_p, xl_p = pad(xh), pad(xl)
    tf32x3 = tf32 = 0
    for ky in range(3):
        for kx in range(3):
            hi, lo = xh_p[:, ky:ky + h, kx:kx + w], xl_p[:, ky:ky + h, kx:kx + w]
            b_hi, b_lo = torch.from_numpy(kh[ky, kx]), torch.from_numpy(kl[ky, kx])
            tf32x3 = tf32x3 + ((lo @ b_hi + hi @ b_lo) + hi @ b_hi)
            tf32 = tf32 + hi @ b_hi
    assert tf32x3.dtype == torch.float32
    want = kconv.conv3x3_plain(torch.from_numpy(x).double(), torch.from_numpy(k).double())
    scale = float(want.abs().max())
    err3 = float((tf32x3.double() - want).abs().max()) / scale
    err1 = float((tf32.double() - want).abs().max()) / scale
    assert err3 <= cs.CONV_TOL < err1, (err3, err1)
    assert cs.CONV_TOL == 1e-5


def test_chip_smoke_conv_ladder_runs_on_cpu():
    """chip_smoke.py's conv-ladder phase on the CPU at a small plane: its
    shapes and checks are exercised here, its numbers only on a card."""
    launches = _chip_smoke().check_conv_ladder(np.random.default_rng(0), device="cpu",
                                               shape=32, batch=1)
    assert launches == {}  # CPU tensors take the plain version


# ------------------------------------------------------------ the nets' route
class _OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card: the route and the
    kernel's wrapper read its `.device`; the stand-ins below compute on the
    CPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _to_card(module):
    """`module` with each parameter an `_OnCard` copy of its values."""
    for m in module.modules():
        for name, p in list(m._parameters.items()):
            if p is not None:
                m._parameters[name] = torch.nn.Parameter(
                    p.detach().clone().as_subclass(_OnCard), p.requires_grad)
    return module


@pytest.fixture
def card(monkeypatch):
    """True f32 on the card for `_OnCard` tensors: cuDNN's TF32 off, the
    wrapper's output allocated on the CPU as `_OnCard`, its shape checks
    on the tensors' CPU selves (a copy the op makes inside is a plain
    tensor), a stand-in stream, and a launcher that records its arguments
    and returns 0 (the output stays uninitialised: for counting launches,
    not values)."""
    launched = []
    empty = torch.empty
    check = kconv.check

    def alloc(*shape, device=None, **kw):
        t = empty(*shape, **kw)
        return t.as_subclass(_OnCard) if torch.device(device or "cpu").type == "cuda" else t

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch, "empty", alloc)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(kconv, "_launcher", lambda: lambda *args: launched.append(args) or 0)
    monkeypatch.setattr(kconv, "check", lambda x, w3: check(x.as_subclass(torch.Tensor),
                                                            w3.as_subclass(torch.Tensor)))
    kernels.reset_launches()
    yield launched
    kernels.reset_launches()


def test_unet_forward_launches_the_kernel_once_a_conv(card):
    """On the card in true f32, a U-Net forward (4 pools, the nets' depth)
    launches the f32 kernel once for each of its 18 ConvBlock convs, on
    NHWC views (flag 0, f32), and no bf16 kernel. Only the first conv's
    input is copied to channels-last: each block's second conv reads the
    first's output through the norm and activation in that layout."""
    from spatialalignmentnetwork_tpu_torch.models.layers import Conv3x3
    from spatialalignmentnetwork_tpu_torch.models.unet import Unet

    net = _to_card(Unet(3, 2, 4, 4))
    convs = [m for m in net.modules() if isinstance(m, Conv3x3)]
    layouts = []
    for m in convs:
        m.register_forward_pre_hook(lambda m, i: layouts.append(
            (m is convs[0], i[0].is_contiguous(memory_format=torch.channels_last))))
    x = torch.rand((2, 3, 32, 32)).as_subclass(_OnCard)
    with torch.no_grad():
        out = net(x)
    assert tuple(out.shape) == (2, 2, 32, 32) and out.is_contiguous()
    assert len(convs) == 18 and dict(kernels.LAUNCHES) == {kconv.NAME: 18}
    assert len(card) == 18 and all(args[8] == 0 for args in card)
    assert layouts[0] == (True, False)  # the first conv's input: NCHW
    blocks = [m.layers for m in net.modules() if isinstance(m, ConvBlock)]
    assert all(b[3] in convs for b in blocks) and len(blocks) == 9
    seconds = [on for (first, on), m in zip(layouts, convs) if not first
               and any(b[3] is m for b in blocks)]
    assert seconds == [True] * 9


@pytest.mark.parametrize("case", ["bf16", "tf32", "odd_h", "odd_w", "cpu"])
def test_route_bypassed_off_its_conditions(card, monkeypatch, case):
    """bf16 (a compute dtype), cuDNN's TF32 on, an odd H or W, and plain
    CPU tensors take nn.Conv2d's forward: the same bits as F.conv2d, no
    launch. On the card in true f32 at even H and W the route engages."""
    from spatialalignmentnetwork_tpu_torch.models.layers import Conv3x3, set_compute_dtype

    conv = Conv3x3(3, 4)
    weight = conv.weight.detach().clone()
    x = torch.rand((2, 3, 7 if case == "odd_h" else 8, 5 if case == "odd_w" else 6))
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    want = F.conv2d(x.to(dtype), weight.to(dtype), padding=1)
    if case != "cpu":
        conv, x = _to_card(conv), x.as_subclass(_OnCard)
        assert conv.routed(x[..., :4, :4])  # true f32 on the card, even H and W
    if case == "bf16":
        set_compute_dtype(conv, torch.bfloat16)
    if case == "tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert not conv.routed(x)
    with torch.no_grad():
        got = conv(x)
    assert got.dtype == dtype and torch.equal(got.as_subclass(torch.Tensor), want)
    assert not kernels.LAUNCHES and not card


def test_routed_norm_unet_matches_nn_conv2d(card, monkeypatch):
    """A routed NormUnet (the cascade's: a reference channel, 2 pools) on
    the card, the plain version standing in for the kernel, gives the
    output and the parameter gradients of the same net on CPU tensors
    (nn.Conv2d throughout), at f32 tolerance. The forward launches once a
    conv (10); the backward once more for each conv's input gradient but
    the first's, whose input needs none (9)."""
    from spatialalignmentnetwork_tpu_torch.models.unet import NormUnet

    def standin(x, w3):
        assert x.is_contiguous() and w3.is_contiguous()
        kernels.check_launch(kconv.NAME, 0)
        return kconv.conv3x3_plain(x, w3)

    monkeypatch.setattr(kconv, "conv3x3_cuda", standin)
    # autograd's gradients are plain tensors: the op takes every tensor
    # for the card's, as the card's own gradients are
    monkeypatch.setattr(kconv, "on_card", lambda t: True)
    torch.manual_seed(0)
    plain = NormUnet(4, 2, use_ref=True)
    routed = _to_card(NormUnet(4, 2, use_ref=True))
    routed.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(35)
    img = torch.from_numpy((rng.standard_normal((2, 1, 16, 12))
                            + 1j * rng.standard_normal((2, 1, 16, 12))).astype(np.complex64))
    ref = torch.from_numpy(rng.random((2, 1, 16, 16)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 1, 16, 12, 2)).astype(np.float32))
    outs = []
    for net, on in ((plain, lambda t: t), (routed, lambda t: t.as_subclass(_OnCard))):
        out = net(on(img), on(ref))
        (torch.view_as_real(out) * on(cot)).sum().backward()
        outs.append(torch.view_as_real(out).detach().as_subclass(torch.Tensor))
    assert dict(kernels.LAUNCHES) == {kconv.NAME: 19}
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), **F32)
    grads = dict(routed.named_parameters())
    for name, p in plain.named_parameters():
        w, got = p.grad.numpy(), grads[name].grad.as_subclass(torch.Tensor).numpy()
        np.testing.assert_allclose(got, w, rtol=GRAD["rtol"],
                                   atol=GRAD["atol_of_max"] * float(np.abs(w).max()))


def test_state_dict_keys_unchanged():
    """ConvBlock's convs keep nn.Conv2d's parameters under `layers.0` and
    `layers.3`, so checkpoints and the JAX loader's names read as before."""
    block = ConvBlock(3, 5)
    sd = block.state_dict()
    assert list(sd) == ["layers.0.weight", "layers.3.weight"]
    assert [tuple(v.shape) for v in sd.values()] == [(5, 3, 3, 3), (5, 5, 3, 3)]
    plain = torch.nn.Sequential(torch.nn.Conv2d(3, 5, 3, padding=1, bias=False),
                                torch.nn.Identity(), torch.nn.Identity(),
                                torch.nn.Conv2d(5, 5, 3, padding=1, bias=False))
    plain.load_state_dict({k.removeprefix("layers."): v for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("requires_grad", [False, True])
def test_flop_counter_counts_the_op_as_aten_counts_the_conv(requires_grad):
    """`FlopCounterMode` (utils/profiler.py's `flops_of`) counts
    `san::conv3x3` by its registered formula as it counts the same conv
    through aten's convolution, forward and, with gradients, backward (the
    input gradient through the op, the weight gradient through aten)."""
    from torch.utils.flop_counter import FlopCounterMode

    x, k, _ = _inputs((2, 8, 6, 3, 5), 36)
    counts = []
    for run in (lambda a, b: kconv.conv3x3_s2d(a, b),
                lambda a, b: F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1), padding=1)):
        a = torch.from_numpy(x).requires_grad_(requires_grad)
        b = torch.from_numpy(k).requires_grad_(requires_grad)
        with FlopCounterMode(display=False) as counter:
            out = run(a, b)
            if requires_grad:
                out.sum().backward()
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1] == 2 * 2 * 8 * 6 * 9 * 3 * 5 * (3 if requires_grad else 1)


def test_hwio_copy_kept_while_no_gradient_is_taken(monkeypatch):
    """Without a gradient to take, a routed conv's HWIO weight is one copy
    kept across calls until the weight changes (an in-place write bumps its
    version) or inference mode is entered; where a gradient is taken the
    op gets an HWIO view that autograd follows, and the weight's gradient
    comes back in the weight's own OIHW layout (no layout-contract copy).
    The route is forced on CPU tensors: the op takes the plain version."""
    from spatialalignmentnetwork_tpu_torch.models.layers import Conv3x3

    monkeypatch.setattr(Conv3x3, "routed", lambda self, x: True)
    seen = []
    op = kconv.conv3x3_op

    def spy(x, w3):
        seen.append(w3)
        return op(x, w3)

    monkeypatch.setattr("spatialalignmentnetwork_tpu_torch.models.layers.conv3x3_op", spy)
    torch.manual_seed(0)
    conv = Conv3x3(3, 4)
    x = torch.rand((2, 3, 8, 6))
    with torch.no_grad():
        a, b = conv(x), conv(x)
        conv.weight.mul_(2.0)
        c = conv(x)
    with torch.inference_mode():
        d = conv(x)
    assert seen[0] is seen[1] and seen[2] is not seen[1] and seen[3] is not seen[2]
    assert all(w.is_contiguous() for w in seen)
    want = F.conv2d(x, conv.weight.detach(), padding=1)
    np.testing.assert_allclose(c.numpy(), want.numpy(), **F32)
    np.testing.assert_allclose(a.numpy(), (want / 2).numpy(), **F32)
    np.testing.assert_allclose(d.numpy(), want.numpy(), **F32)
    assert torch.equal(a, b)

    out = conv(x.requires_grad_())
    assert not seen[4].is_contiguous() and seen[4]._base is conv.weight
    out.square().sum().backward()
    assert conv.weight.grad.is_contiguous() and x.grad.shape == x.shape
    ref = torch.nn.Conv2d(3, 4, 3, padding=1, bias=False)
    with torch.no_grad():
        ref.weight.copy_(conv.weight)
    ref(x.detach()).square().sum().backward()
    np.testing.assert_allclose(conv.weight.grad.numpy(), ref.weight.grad.numpy(),
                               rtol=GRAD["rtol"],
                               atol=GRAD["atol_of_max"] * float(ref.weight.grad.abs().max()))


def test_routed_weight_gradient_in_the_weights_layout_from_channels_last(monkeypatch):
    """A routed conv on a channels-last input (what a routed conv before it
    hands on): the library's backward-filter then gives a channels-last
    OIHW gradient, which the route hands back as the parameter's own
    contiguous layout (the gradient layout contract), equal to nn.Conv2d's
    gradient. The route is forced on CPU tensors."""
    from spatialalignmentnetwork_tpu_torch.models.layers import Conv3x3

    monkeypatch.setattr(Conv3x3, "routed", lambda self, x: True)
    torch.manual_seed(1)
    conv = Conv3x3(5, 6)
    x = torch.rand((2, 5, 8, 6)).contiguous(memory_format=torch.channels_last)
    grads = []
    conv.weight.register_hook(grads.append)
    conv(x).square().sum().backward()
    assert grads[0].stride() == conv.weight.stride()
    assert conv.weight.grad.stride() == conv.weight.stride()
    ref = torch.nn.Conv2d(5, 6, 3, padding=1, bias=False)
    with torch.no_grad():
        ref.weight.copy_(conv.weight)
    ref(x).square().sum().backward()
    np.testing.assert_allclose(conv.weight.grad.numpy(), ref.weight.grad.numpy(),
                               rtol=GRAD["rtol"],
                               atol=GRAD["atol_of_max"] * float(ref.weight.grad.abs().max()))


def test_routed_conv_built_in_inference_mode(monkeypatch):
    """A conv built in inference mode (the profiler's nets) has an inference
    tensor as weight, which keeps no version: the route takes the HWIO view
    each call and keeps no copy. The route is forced on CPU tensors."""
    from spatialalignmentnetwork_tpu_torch.models.layers import Conv3x3

    monkeypatch.setattr(Conv3x3, "routed", lambda self, x: True)
    torch.manual_seed(2)
    with torch.inference_mode():
        conv = Conv3x3(3, 4)
        x = torch.rand((2, 3, 8, 6))
        out = conv(x)
        want = F.conv2d(x, conv.weight, padding=1)
    assert conv.weight.is_inference() and conv._hwio_copy is None
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32)
