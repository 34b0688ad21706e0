"""The benchmark's arithmetic on synthetic events and timings: the p95,
the device's busy time and idle gaps from a Chrome trace, the
conv layer's attribution by launch stacks, the MFU and the kernels' bound."""

import collections
import math

import numpy as np
import pytest

from harness import readers, roofline, stats
from harness.cell import Run
from harness.registry import Registry
from harness.trace import WINDOW, Trace


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200):
        xs = list(rng.standard_normal(n))
        for q in (0, 50, 95, 100):
            assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_union_counts_overlaps_once_and_clips_to_the_window():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.union_seconds(iv, 0.0, 10.0) == pytest.approx(3.0 + 1.0 + 1.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(6.0, 9.0), (3.0, 5.0)]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def synthetic_trace():
    """A 1000 us window: a conv op launching a kernel (200 us on the
    device), a backward on another thread launching one (100 us), a copy
    launching one (50 us), and a readback during which the device idles."""
    return Trace([
        _ev("user_annotation", WINDOW, 0, 1000),
        _ev("cpu_op", "aten::conv2d", 10, 50),
        _ev("cpu_op", "aten::cudnn_convolution", 20, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 25, 5, corr=1),
        _ev("kernel", "implicit_gemm", 100, 200, tid=7, corr=1),
        _ev("cpu_op", "aten::convolution_backward", 60, 20, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 65, 5, tid=2, corr=2),
        _ev("kernel", "dgrad_engine", 300, 100, tid=7, corr=2),
        _ev("cpu_op", "aten::copy_", 90, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 92, 2, corr=3),
        _ev("kernel", "grid_sample_fwd_kernel<float>", 400, 50, tid=7, corr=3),
        _ev("user_annotation", "portbench.readback", 450, 500),
    ])


def test_trace_busy_idle_and_attribution():
    tr = synthetic_trace()
    assert tr.window_s() == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(350e-6)
    conv = Registry().load("layers", "conv")
    assert tr.device_s(kernels=conv["kernels"], ops=conv["ops"]) == pytest.approx(300e-6)
    assert tr.device_s(kernels=["grid_sample_fwd_kernel"]) == pytest.approx(50e-6)
    top = tr.top_device_ops(2)
    assert [n for n, _ in top] == ["implicit_gemm", "dgrad_engine"]
    label, secs = tr.idle_gaps(1)[0]
    assert label == "portbench.readback" and secs == pytest.approx(550e-6)


def _loop(cell_name):
    reg = Registry()
    cell = reg.cell(cell_name)
    return reg.loop(cell["traffic"]["loop"])(Run(cell, 1, "cpu"))


def _readings(kind, stretch, trace=None, units=1, work=()):
    loop = _loop("serve_f32_b8" if kind == "serve" else "train_mixed_f32_b4")
    return readers.Readings(kind, stretch, trace, units, loop.flops_per_slice(), list(work),
                            67e12, Registry())


def test_mfu_counts_the_frozen_flops_at_the_configs_peak():
    r = _readings("serve", {"slices_per_s": 62.0})
    assert readers.mfu(r, "serve") == pytest.approx(100 * 123.714964e9 * 62.0 / 67e12, rel=1e-6)
    assert readers.mfu(r, "train") is None
    t = _readings("train", {"train_slices_per_s": 7.5})
    assert readers.mfu(t, "train") == pytest.approx(100 * 1180.3195e9 * 7.5 / 67e12, rel=1e-6)


def test_kernel_work_takes_the_launches_counted_in_each_phase():
    """The counts are the run's; the shapes the loop's: a kernel with no
    shape in its phase, and a phase the loop does not name, are left out."""
    loop = _loop("train_mixed_f32_b4")
    loop.launched.by_phase = {
        "augment": collections.Counter(grid_sample_fwd=6),
        "update": collections.Counter(grid_sample_fwd=12, ssim_bwd=3, conv3x3=40),
        "elsewhere": collections.Counter(grid_sample_fwd=5)}
    assert loop.kernel_work() == [
        {"op": "grid_sample_fwd", "count": 6, "batch": 4, "channels": 2, "side": 352},
        {"op": "grid_sample_fwd", "count": 12, "batch": 4, "channels": 1, "side": 320},
        {"op": "ssim_bwd", "count": 3, "batch": 4, "channels": 1, "side": 320}]


def test_kernel_roofline_is_the_bound_over_the_device_time():
    tr = synthetic_trace()
    loop = _loop("serve_f32_b8")
    loop.launched.by_phase = {"reconstruct": collections.Counter(grid_sample_fwd=1)}
    r = _readings("serve", {}, tr, units=1, work=loop.kernel_work())
    nbytes, flops = roofline.op_work("grid_sample_fwd", 8, 1, 320, 320)
    assert nbytes == 4 * 8 * 320 * 320 * 3 + 4 * 8 * 320 * 320  # image, grid (2 floats), out
    want = 100 * max(nbytes / 3.35e12, flops / 67e12) / 50e-6
    assert readers.kernel_roofline(r, "serve") == pytest.approx(want)
    assert readers.idle_share(r, "serve") == pytest.approx(65.0)
    assert readers.conv_ms(r, "serve") == pytest.approx(0.3)
    assert readers.kernel_roofline(_readings("serve", {}, tr), "serve") is None  # no launches


def test_readers_find_nothing_where_nothing_is_read():
    r = _readings("serve", {"slices_per_s": 1.0})
    for name, (read, unit) in Registry().readers().items():
        if name.endswith(".train"):
            assert read(r) is None, name
    assert readers.idle_share(r, "serve") is None  # no trace
    assert math.isfinite(readers.mfu(r, "serve"))


def test_serving_numbers_take_the_worst_slice_against_its_own_yardstick():
    from harness import check

    want = {0: np.ones((3, 1, 4, 4)), 1: 2 * np.ones((2, 1, 4, 4))}
    got = [(0, want[0] * np.array([1.01, 1.01, 1.50])[:, None, None, None]),
           (1, want[1] * 1.02)]
    yard = [(0, want[0] * 1.01), (1, want[1] * np.array([1.04, 1.01])[:, None, None, None])]
    out = check.serve_numbers(got, want, yard)
    assert out["rec_rel_l2"] == pytest.approx(0.5)
    assert out["rec_rel_l2_median"] == pytest.approx(0.02)  # of 0.01, 0.01, 0.5, 0.02, 0.02
    assert out["rec_over_yardstick"] == pytest.approx(0.02 / 0.01)
    assert out["slice_over_yardstick"] == pytest.approx(0.5 / 0.01)
    with pytest.raises(ValueError):
        check.serve_numbers(got, want, yard[::-1])
