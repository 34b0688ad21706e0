"""The port's library and tooling against the JAX package's, on the CPU.

  * `utils/flops.py` equals the JAX package's analytic counts exactly,
    for the native FFT (its fft_impl="xla"), over shapes and widths;
  * PyTorch's flop counter on each port net at tiny widths equals the
    copy's conv and transposed-conv terms (it sees no FFT and no
    elementwise work, which the copy bills);
  * the profiler's nets hold the JAX profiler's parameter counts at full
    widths (JAX's from `jax.eval_shape` of each init: nothing compiles);
    its `main` runs on the CPU and counts what `analytic_flops` says;
  * `marginal_time` gives JAX's estimate on the same fake clock;
  * `Locker` excludes and blocks as the JAX one (tests/test_utils.py), and
    `auto_gpu` sets CUDA_VISIBLE_DEVICES, refusing once CUDA is up;
  * both examples run on the CPU.
"""

import itertools
import os
import sys
import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.models.gan import NetD as JNetD, NetG as JNetG
from spatialalignmentnetwork_tpu.models.stn import SpatialTransformer as JSTN
from spatialalignmentnetwork_tpu.models.varnet import VarNet as JVarNet
from spatialalignmentnetwork_tpu.utils import flops as jflops
from spatialalignmentnetwork_tpu.utils import timing as jtiming

from spatialalignmentnetwork_tpu_torch.models.gan import NetD, NetG
from spatialalignmentnetwork_tpu_torch.models.stn import SpatialTransformer
from spatialalignmentnetwork_tpu_torch.models.varnet import VarNet
from spatialalignmentnetwork_tpu_torch.utils import autogpu, profiler
from spatialalignmentnetwork_tpu_torch.utils import flops as tflops
from spatialalignmentnetwork_tpu_torch.utils import timing as ttiming

torch.set_num_threads(2)

# (num_cascades, sens_chans, sens_pools, chans, pools) of net_R,
# (stn_feat, stn_layers), g_layers, d_blocks: the defaults and tiny ones
WIDTHS = [
    dict(),
    dict(num_cascades=2, sens_chans=4, sens_pools=1, chans=4, pools=1,
         stn_feat=4, stn_layers=(4, 8), g_layers=(4, 8), d_blocks=((4,), (8,))),
]
SHAPES = [24, 320, 352]


def _varnet(w):
    return {k: w[k] for k in ("num_cascades", "sens_chans", "sens_pools", "chans", "pools")
            if k in w}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("widths", range(len(WIDTHS)))
def test_flops_equal_jax(shape, widths):
    w = WIDTHS[widths]
    vn = _varnet(w)
    stn = {"feat": w["stn_feat"], "layers": w["stn_layers"]} if "stn_feat" in w else {}
    g = {"layers": w["g_layers"]} if "g_layers" in w else {}
    d = {"blocks": w["d_blocks"]} if "d_blocks" in w else {}
    for coils in (1, 2):
        assert tflops.fft2_flops(shape, shape, coils) == jflops.fft2_flops(shape, shape, coils,
                                                                           "xla")
        assert tflops.varnet_flops(shape, coils, **vn) == jflops.varnet_flops(
            shape, coils, **vn, fft_impl="xla")
        assert tflops.varnet_flops_parts(shape, coils, **vn) == jflops.varnet_flops_parts(
            shape, coils, **vn, fft_impl="xla")
        assert tflops.varnet_convs(shape, coils, **vn) == jflops.varnet_convs(
            shape, coils, **vn, fft_impl="xla")
        assert tflops.stn_flops(shape, coils, **stn) == jflops.stn_flops(shape, coils, **stn)
        assert tflops.stn_convs(shape, coils, **stn) == jflops.stn_convs(shape, coils, **stn)
    for args in ((shape, shape, 3, 3, 5, 7), (shape, shape // 2, 1, 1, 2, 3)):
        assert tflops.conv2d_flops(*args) == jflops.conv2d_flops(*args)
    for fn in ("unet_flops", "unet_convs"):
        args = (shape, shape, 3, 2, 18, 4)
        assert getattr(tflops, fn)(*args) == getattr(jflops, fn)(*args)
    for fn in ("normunet_flops", "normunet_convs"):
        assert getattr(tflops, fn)(shape, shape, 8, 4, use_ref=True) == getattr(jflops, fn)(
            shape, shape, 8, 4, use_ref=True)
    for fn in ("libunet_flops", "libunet_convs"):
        assert getattr(tflops, fn)(shape, shape, 2, 32) == getattr(jflops, fn)(
            shape, shape, 2, 32)
    assert tflops.netg_flops(shape, **g) == jflops.netg_flops(shape, **g)
    assert tflops.netg_convs(shape, **g) == jflops.netg_convs(shape, **g)
    assert tflops.netd_flops(shape, **d) == jflops.netd_flops(shape, **d)
    assert tflops.netd_convs(shape, **d) == jflops.netd_convs(shape, **d)
    for regime, remat, remat_tg in itertools.product(
            ("None", "Rec", "Mixed", "GAN-Only"), (False, True), (False, True)):
        assert tflops.train_step_flops(regime, shape, 1, remat, remat_tg, **w) == \
            jflops.train_step_flops(regime, shape, 1, "xla", "full" if remat else "none",
                                    remat_tg, **w)
    with pytest.raises(ValueError, match="unknown regime"):
        tflops.train_step_flops("Other", shape)


def _convs(records):
    return sum(r["flops"] for r in records if r["kind"] in ("conv", "convT"))


@pytest.mark.parametrize("net", ["NetD", "NetG", "NetT", "NetR"])
def test_flop_counter_sees_the_conv_terms(net):
    """FlopCounterMode on each port net at tiny widths, batch 2, at a plane
    NormUnet pads (24 -> 32): the copy's conv and transposed-conv terms,
    batch times. The copy's FFT ('dft') and sensitivity products ('ew')
    are what the counter does not see: cuFFT and elementwise work."""
    shape, n = 24, 2
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.random((n, 1, shape, shape)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    if net == "NetD":
        module, args = NetD(((4,), (8,)), generator=gen), (torch.cat([x, x], 1),)
        want = _convs(tflops.netd_convs(shape, blocks=((4,), (8,))))
    elif net == "NetG":
        module, args = NetG(layers=(4, 8), generator=gen), (x,)
        want = _convs(tflops.netg_convs(shape, layers=(4, 8)))
    elif net == "NetT":
        module, args = SpatialTransformer(1, 4, (4, 8)), (x, x)
        want = _convs(tflops.stn_convs(shape, feat=4, layers=(4, 8)))
    else:
        module = VarNet(num_cascades=2, sens_chans=4, sens_pools=1, chans=4, pools=1,
                        use_ref=True)
        k = torch.complex(x, x.flip(-1))
        args = (k, torch.ones(shape, dtype=torch.bool), x, 2)
        sens, casc, edge = tflops.varnet_convs(shape, 1, 2, 4, 1, 4, 1, True)
        want = _convs(sens) + 2 * _convs(casc) + _convs(edge)
        assert {r["kind"] for r in sens + casc + edge} - {"conv", "convT"} == {"dft", "ew"}
    with torch.no_grad():
        assert profiler.flops_of(module.eval(), *args) == n * want


def test_profiler_param_counts_equal_jax():
    """The profiler's four nets at the JAX profiler's full widths: the
    same parameter counts (JAX's `params` collection; the port's
    parameters, its BatchNorm statistics and spectral vectors being
    buffers)."""
    shape = 32
    full = jax.ShapeDtypeStruct((1, 1, shape, shape), jnp.complex64)
    rss = jax.ShapeDtypeStruct((1, 1, shape, shape), jnp.float32)
    key = jax.random.PRNGKey(0)
    net_r = JVarNet(num_cascades=8, sens_chans=8, sens_pools=4, chans=18, pools=4,
                    use_ref=True)
    inits = {
        "NetD": jax.eval_shape(lambda x: JNetD().init({"params": key}, x, train=False),
                               jax.ShapeDtypeStruct((1, 2, shape, shape), jnp.float32)),
        "NetG": jax.eval_shape(lambda x: JNetG().init({"params": key}, x, train=False), rss),
        "NetT": jax.eval_shape(lambda a, b: JSTN(channels=1).init({"params": key}, a, b,
                                                                  train=False), rss, rss),
        "NetR": jax.eval_shape(lambda k, m, r: net_r.init(key, k, m, r, 2), full,
                               jax.ShapeDtypeStruct((shape,), jnp.bool_), rss),
    }
    want = {name: sum(int(np.prod(leaf.shape))
                      for leaf in jax.tree_util.tree_leaves(v["params"]))
            for name, v in inits.items()}
    got = {name: profiler.param_count(module)
           for name, module, _ in profiler.nets(shape, 1, "cpu")}
    assert got == want


def test_profiler_main_runs_on_cpu(capsys):
    rows = profiler.main(["--shape", "32", "--repeat", "1", "--device", "cpu"])
    assert [r[0] for r in rows] == ["NetD", "NetG", "NetT", "NetR"]
    want = profiler.analytic_flops(32)
    for name, params, flops, seconds in rows:
        assert flops == want[name] and params > 0 and seconds > 0
    lines = capsys.readouterr().out.strip().splitlines()[-4:]
    for line, (name, params, flops, seconds) in zip(lines, rows):
        assert line == (f"{name}: {flops / 2e9:.2f} GMac; {params / 1e6:.2f} M parameters; "
                        f"{seconds * 1000:.2f} ms time")


def test_trace_writes_a_trace(tmp_path):
    with profiler.trace(str(tmp_path)):
        torch.ones(4).add_(1)
    (path,) = tmp_path.iterdir()
    assert path.name.endswith(".pt.trace.json") and path.stat().st_size > 0


def test_marginal_time_equals_jax_on_a_fake_clock(monkeypatch):
    """A chain of n iterations takes 25 ms of fixed cost, 3 ms an
    iteration and some jitter: both packages strip the fixed cost alike."""
    jitter = [0.004, 0.0, 0.002, 0.001, 0.003, 0.0005]

    def estimate(module):
        clock = {"t": 100.0, "k": 0}

        def perf_counter():
            return clock["t"]

        def make_chain(n):
            def chain(x):
                clock["t"] += 0.025 + 0.003 * n + jitter[clock["k"] % len(jitter)]
                clock["k"] += 1
                return np.float32(x)
            return chain

        monkeypatch.setattr(time, "perf_counter", perf_counter)
        return module.marginal_time(make_chain, (1.0,), iters=10)

    got, want = estimate(ttiming), estimate(jtiming)
    assert got == want
    assert got == pytest.approx(0.003, abs=4e-4)


def test_locker_mutual_exclusion(tmp_path):
    path = str(tmp_path / "lock")
    a = autogpu.Locker(path)
    assert a.acquire(blocking=False)
    b = autogpu.Locker(path)
    assert not b.acquire(blocking=False)  # held by a
    a.release()
    assert b.acquire(blocking=False)
    b.release()


def test_locker_blocks_until_released(tmp_path):
    path = str(tmp_path / "lock")
    a = autogpu.Locker(path)
    a.acquire()
    got = []

    def taker():
        with autogpu.Locker(path):
            got.append(time.time())

    t = threading.Thread(target=taker)
    t.start()
    time.sleep(0.3)
    assert not got  # still blocked
    released_at = time.time()
    a.release()
    t.join(timeout=5)
    assert got and got[0] >= released_at


def test_auto_gpu_sets_the_devices_and_refuses_after_cuda_init(monkeypatch, tmp_path):
    assert autogpu.LOCK_PATH.endswith("wait_gpu_666.lock")  # not the TPU lock
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "unset")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert autogpu.auto_gpu() is None
    assert autogpu.auto_gpu("1,0") is None
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1,0"
    monkeypatch.setattr(autogpu, "LOCK_PATH", str(tmp_path / "lock"))
    lock = autogpu.auto_gpu("0", exclusive=True)
    try:
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
        assert not autogpu.Locker(str(tmp_path / "lock")).acquire(blocking=False)
    finally:
        lock.release()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialized already"):
        autogpu.auto_gpu("1")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"


def test_examples_run_on_cpu(tmp_path, monkeypatch, capsys):
    """The quickstart (train CLI one epoch, then the eval CLI), then the
    serving example on its checkpoint, data-parallel over a world of 1.
    TensorBoard's writer needs only the tensorboard package: TensorFlow
    (whose import alone takes about 20 s on a CPU) is kept out."""
    from examples import torch_quickstart, torch_serve

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    ckpt, scalars = torch_quickstart.main(["--epochs", "1", "--device", "cpu",
                                           "--workdir", str(tmp_path)])
    assert np.isfinite(scalars["metric_PSNR"])
    torch_serve.main(["--resume", ckpt, "--device", "cpu", "--batch", "2",
                      "--data_parallel"])
    out = capsys.readouterr().out
    assert "serving data-parallel over 1 rank(s) (gloo)" in out
    assert "reloaded artifact matches the live serving path" in out
    assert not torch.distributed.is_initialized()
