"""The readers of the program's own spans and set-up record
(`harness/spans.py`) on a synthetic trace: each reads its span, finds
nothing in a cell of the other kind, and nothing in a trace of a program
without the spans."""

import pytest

from harness import spans
from harness.registry import Registry
from harness.trace import WINDOW, Trace
from test_portbench_stats import _ev, _readings


def step_trace(with_spans=True):
    """A 1000 us window on thread 1: set_input's copy, then one train step
    whose backward launches on thread 2. net_G launches kernels of 100 and
    30 us, net_D one of 40 us, the optimizer one of 10 us. The device
    idles 80 us while the host runs net_G's code between ops, 200 us under
    san.update alone, 10 us under san.optimizer, 250 us while the host
    waits in san.backward, 20 us inside the copy and 30 us inside a conv
    op under san.net_D; the host spends 40 us in san.to_device. Without
    the spans, the same ops alone."""
    def sp(name, ts, dur):
        return [_ev("user_annotation", name, ts, dur)] if with_spans else []
    return Trace([
        _ev("user_annotation", WINDOW, 0, 1000),
        *sp("san.to_device", 5, 40),
        _ev("cpu_op", "aten::copy_", 8, 22),
        _ev("cuda_runtime", "cudaMemcpyAsync", 12, 5, corr=9),
        _ev("gpu_memcpy", "Memcpy HtoD", 20, 20, tid=7, corr=9),
        *sp("san.update", 60, 900),
        *sp("san.net_G", 100, 200),
        _ev("cpu_op", "aten::conv2d", 110, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 115, 5, corr=1),
        _ev("kernel", "gemm_g", 120, 100, tid=7, corr=1),
        _ev("cpu_op", "aten::relu", 290, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 295, 2, corr=2),
        _ev("kernel", "relu_g", 300, 30, tid=7, corr=2),
        *sp("san.net_D", 400, 200),
        _ev("cpu_op", "aten::conv2d", 430, 80),
        _ev("cuda_runtime", "cudaLaunchKernel", 440, 5, corr=3),
        _ev("kernel", "gemm_d", 450, 40, tid=7, corr=3),
        _ev("cpu_op", "autograd::engine::evaluate_function", 500, 100, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 5, tid=2, corr=4),
        _ev("kernel", "dgrad_d", 520, 180, tid=7, corr=4),
        *sp("san.optimizer", 700, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 705, 5, corr=5),
        _ev("kernel", "multi_tensor_apply", 710, 10, tid=7, corr=5),
        *sp("san.backward", 810, 140),
        _ev("cpu_op", "aten::copy_", 960, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 961, 2, corr=6),
        _ev("kernel", "readback", 970, 30, tid=7, corr=6),
    ])


def test_named_gaps_name_every_gap_as_idle_gaps_does():
    tr = step_trace()
    named = sorted(spans.named_gaps(tr), key=lambda g: -g[1])
    assert [(n, pytest.approx(s)) for n, s in named] == [
        (n, pytest.approx(s)) for n, s in tr.idle_gaps(len(named))]
    totals = {}
    for n, s in named:
        totals[n] = totals.get(n, 0) + round(s * 1e6)
    assert totals == {"aten::copy_": 20, "san.update": 80 + 120, "san.net_G": 80,
                      "aten::conv2d": 30, "san.optimizer": 10, "san.backward": 250}


def test_device_host_and_idle_readers_read_their_spans():
    tr = step_trace()
    r = _readings("train", {}, tr, units=2)
    readers = Registry().readers()
    assert readers["net_G_fwd_ms.train"][0](r) == pytest.approx((0.100 + 0.030) / 2)
    assert readers["net_D_fwd_ms.train"][0](r) == pytest.approx(0.040 / 2)  # not its backward
    assert readers["optimizer_ms.train"][0](r) == pytest.approx(0.010 / 2)
    # the gaps named by a span, not the 50 us inside an op; the backward's
    # wait apart
    assert readers["idle_between_ops_ms.train"][0](r) == pytest.approx(0.290 / 2)
    assert readers["idle_in_backward_ms.train"][0](r) == pytest.approx(0.250 / 2)
    s = _readings("serve", {}, tr, units=2)
    assert readers["idle_between_ops_ms.serve"][0](s) == pytest.approx(0.290 / 2)
    assert readers["input_copy_ms.serve"][0](s) == pytest.approx(0.040 / 2)
    for name in ("net_G_fwd_ms.train", "net_D_fwd_ms.train", "optimizer_ms.train",
                 "idle_between_ops_ms.train", "idle_in_backward_ms.train"):
        assert readers[name][0](s) is None, name
    for name in ("idle_between_ops_ms.serve", "input_copy_ms.serve"):
        assert readers[name][0](r) is None, name


def test_a_program_without_the_spans_reads_nothing():
    tr = step_trace(with_spans=False)
    readers = Registry().readers()
    for kind in ("train", "serve"):
        r = _readings(kind, {}, tr, units=2)
        for name in ("net_G_fwd_ms", "net_D_fwd_ms", "optimizer_ms", "idle_between_ops_ms",
                     "idle_in_backward_ms", "input_copy_ms"):
            if f"{name}.{kind}" in readers:
                assert readers[f"{name}.{kind}"][0](r) is None, name


def test_model_build_reads_the_build_phases_of_the_set_up_record(monkeypatch):
    from spatialalignmentnetwork_tpu_torch.utils import trace

    readers = Registry().readers()
    monkeypatch.setattr(trace, "SETUP", {})
    r = _readings("train", {})
    assert readers["model_build_s.train"][0](r) is None
    monkeypatch.setattr(trace, "SETUP", {"build.net_T": 1.5, "kernel_build.ssim.cu": 9.0,
                                         "build.to_device": 0.25})
    assert readers["model_build_s.train"][0](r) == pytest.approx(1.75)
    assert readers["model_build_s.serve"][0](r) is None
    assert readers["model_build_s.serve"][0](_readings("serve", {})) == pytest.approx(1.75)


def test_kernel_build_reads_the_nvcc_runs_of_the_set_up_record(monkeypatch):
    from spatialalignmentnetwork_tpu_torch.utils import trace

    readers = Registry().readers()
    monkeypatch.setattr(trace, "SETUP", {"build.net_T": 1.5})
    r = _readings("serve", {})
    assert readers["kernel_build_s.serve"][0](r) == 0  # the libraries were built before
    monkeypatch.setattr(trace, "SETUP", {"kernel_build.ssim.cu": 9.0, "build.net_T": 1.5,
                                         "kernel_build.grid_sample.cu": 12.5})
    assert readers["kernel_build_s.serve"][0](r) == pytest.approx(21.5)
    assert readers["kernel_build_s.train"][0](r) is None
    assert readers["kernel_build_s.train"][0](_readings("train", {})) == pytest.approx(21.5)


@pytest.mark.parametrize("name", ["model_build_s.serve", "kernel_build_s.serve"])
def test_model_build_reads_nothing_of_a_program_without_the_record(monkeypatch, name):
    import sys

    monkeypatch.setitem(sys.modules, "spatialalignmentnetwork_tpu_torch.utils.trace", None)
    assert Registry().readers()[name][0](_readings("serve", {})) is None
