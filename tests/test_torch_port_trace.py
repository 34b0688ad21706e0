"""The port traced from inside (`utils/trace.py`): with no profiler its
spans are one shared no-op and call no profiler op; under
`torch.profiler` a Mixed step's and a request's spans are in the trace,
nested under their outer span; `CSModel.build` and `kernels.build` fill
the set-up record; the train CLI's `--trace_at`
traces a whole iteration, its data wait included. On the CPU at a tiny
configuration."""

import collections
import json
import os
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine import train as ttrain
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
from spatialalignmentnetwork_tpu_torch.utils import trace

torch.set_num_threads(2)
SHAPE = 16
# the spans of one Mixed step, each under san.update, and their count a step
STEP_SPANS = {"san.prepare": 1, "san.net_T": 1, "san.net_G": 2, "san.warp": 2, "san.net_R": 1,
              "san.net_D": 3, "san.loss": 3, "san.backward": 2, "san.optimizer": 1}
REQUEST_SPANS = {"san.to_device": 1, "san.prepare": 1, "san.net_T": 1, "san.warp": 1,
                 "san.net_R": 1}
BUILD_PHASES = ("build.net_T", "build.net_R", "build.net_G", "build.net_D", "build.to_device",
                "build.optimizers", "build.mask")


def _cfg(reg="Mixed"):
    """tests/test_torch_port_train.py's tiny configuration."""
    return Config(sparsity=0.25, lr=1e-4, shape=SHAPE, coils=1, reg=reg, mask="equispaced",
                  weight_smooth=1000.0, weight_gan=0.1, weight_gan_sim=1.0, weight_sim=1.0,
                  net_G_layers=(4, 8), net_D_blocks=((4,), (8,)), net_T_layers=(4, 8),
                  net_R_cascades=2, net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
                  net_R_sens_pools=1)


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.random((n, 1, SHAPE, SHAPE)) + 1j * rng.random((n, 1, SHAPE, SHAPE)))
            .astype(np.complex64) for _ in range(2)]


@pytest.fixture(scope="module")
def model():
    return CSModel(cfg=_cfg(), device="cpu")


def _spans(prof, tmp_path):
    """The profiler's user spans [(name, begin us, end us)] from its
    exported Chrome trace."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _under(spans, outer):
    """{name: count} of the san.* spans that lie inside one `outer` span;
    raises unless there is exactly one `outer` and every other san.* span
    lies inside it."""
    (b, e), = [(b, e) for n, b, e in spans if n == outer]
    inside = [n for n, b2, e2 in spans if n.startswith("san.") and n != outer]
    outside = [n for n, b2, e2 in spans
               if n.startswith("san.") and n != outer and not (b <= b2 and e2 <= e)]
    assert not outside, outside
    return collections.Counter(inside)


def test_without_a_profiler_a_span_is_the_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("san.a") is trace.span("san.b")
    with trace.span("san.a"):
        pass


def test_without_a_profiler_the_port_calls_no_profiler_op(model, monkeypatch):
    """A Mixed step and a request with `record_function` made to raise."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model.train()
    model.set_input(*_batch(1))
    model.update()
    assert np.isfinite(model.get_vis("scalars")["scalars"]["loss_all"])
    model.eval()
    assert model.reconstruct(*_batch(2)).shape == (2, 1, SHAPE, SHAPE)


def test_a_mixed_step_traces_its_spans_under_update(model, tmp_path):
    model.train()
    model.set_input(*_batch(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.update()
    assert _under(_spans(prof, tmp_path), "san.update") == STEP_SPANS


def test_a_request_traces_its_five_spans_under_reconstruct(model, tmp_path):
    model.eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.reconstruct(*_batch(4))
    assert _under(_spans(prof, tmp_path), "san.reconstruct") == REQUEST_SPANS


def test_build_records_each_phase_of_set_up():
    trace.reset()
    assert trace.SETUP == {}
    CSModel(cfg=_cfg(), device="cpu")
    assert tuple(trace.SETUP) == BUILD_PHASES
    assert all(s >= 0 for s in trace.SETUP.values())
    first = dict(trace.SETUP)
    CSModel(cfg=_cfg(), device="cpu")  # a second build adds to each phase
    assert all(trace.SETUP[k] >= first[k] for k in BUILD_PHASES)
    trace.reset()
    assert trace.SETUP == {}


def test_a_mocked_nvcc_build_counts_once(tmp_path, monkeypatch):
    """`kernels.build` runs nvcc once for a source (then reuses its
    library) and times that one run into SETUP."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("__global__ void k() {}\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(out))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(trace, "SETUP", {})
    runs = []

    def run(cmd, **kw):
        runs.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", run)
    lib, _ = kernels.build("k.cu")
    assert kernels.build("k.cu") == (lib, "") and len(runs) == 1
    assert list(trace.SETUP) == ["kernel_build.k.cu"] and trace.SETUP["kernel_build.k.cu"] >= 0
    assert os.path.exists(lib)


@pytest.mark.parametrize("trace_at", [1, 3])
def test_trace_at_traces_a_whole_iteration(tmp_path, monkeypatch, trace_at):
    """`--trace_at N` traces iteration N from the wait for its batch
    through augmentation and the step; N = 3 is the second epoch's first
    iteration (the first epoch has 2), whose trace starts at that
    epoch's first fetch."""
    monkeypatch.setattr(ttrain, "IMAGES_EVERY", 10 ** 6)
    monkeypatch.setattr(ttrain, "IMAGES_EVERY_LATE", 10 ** 6)
    rng = np.random.default_rng(7)
    slices = [[(rng.random((1, SHAPE, SHAPE)) + 0j).astype(np.complex64),
               (rng.random((1, SHAPE, SHAPE)) + 0j).astype(np.complex64)] for _ in range(4)]
    log = tmp_path / "log"
    args = ttrain.build_parser().parse_args([
        "--logdir", str(log), "--train", "mem", "--val", "mem", "--reg", "Mixed",
        "--protocals", "T2", "T1", "--mask", "equispaced", "--sparsity", "0.25",
        "--smooth_weight", "1000", "--gan_weight", "0.1", "--gan_sim_weight", "1",
        "--sim_weight", "1", "--aux_aug", "PBSpline", "--batch_size", "2", "--crop",
        str(SHAPE), "--epoch", "2", "--num_workers", "0", "--seed", "0", "--device", "cpu",
        "--trace_at", str(trace_at)])
    net = CSModel(cfg=_cfg(), device="cpu")
    rec = ttrain.run(net, slices, slices[:2], args)
    assert rec["iter_cnt"] == 4
    name = f"iter_{trace_at:010d}.json"
    assert os.listdir(log / "trace") == [name]
    with open(log / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"] in ("san.data_wait", "san.augment", "san.update"))
    assert [n for _, n in spans] == ["san.data_wait", "san.augment", "san.update"]
