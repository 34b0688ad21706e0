"""The port's export of the serving path against its live path and the
JAX package's export, on the CPU; and the grid sample forward as a
torch.library custom op.

  * `torch.library.opcheck` of `san::grid_sample_fwd` in every padding
    mode, f32 and bf16 images, with and without gradients (the
    AOT-dispatch check with gradients once, f32 in zeros padding);
  * on fake CUDA tensors (FakeTensorMode, what torch.export traces with on
    the card) the op gives a fake CUDA tensor of the output's shape and
    type without reading a pointer or building a kernel;
  * `export_reconstruct` / `load_exported` of a saved tiny JAX checkpoint,
    from bytes and from a path: the replay against the live port (rtol
    1e-5, atol 1e-6) and against the JAX package's own exported replay
    (the serving bar, rtol 1e-3, atol 1e-4); the graph holds the op once
    and no aten grid sampler;
  * under use_amp the replay against the JAX bf16 reconstruct at the bf16
    reconstruct bar (3e-2 relative L2, tests/test_torch_port_amp.py), with
    the grid reaching the op in f32;
  * `torch.library.opcheck` of `san::conv3x3` in f32, with and without
    gradients, and the op on fake CUDA tensors; `export_reconstruct` with
    the nets' conv route engaged holds the op once for each ConvBlock conv
    and replays the live path. (This PyTorch, built for the CPU, cannot
    copy or index fake CUDA tensors, so the route is engaged on CPU
    tensors there: the export traces them as fake tensors alike.)
"""

import os
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.engine import export as jexport

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
from spatialalignmentnetwork_tpu_torch.engine.export import (
    export_reconstruct, load_exported,
)
from spatialalignmentnetwork_tpu_torch.kernels import conv as kconv
from spatialalignmentnetwork_tpu_torch.kernels import grid_sample as kgs
from spatialalignmentnetwork_tpu_torch.models.layers import Conv3x3
from tests.test_torch_port_serve import _batch, tiny_cfg

torch.set_num_threads(2)
LIVE = dict(rtol=1e-5, atol=1e-6)  # the replay against the live path
SERVE = dict(rtol=1e-3, atol=1e-4)  # the port against the JAX package
RECON_BAR = 3e-2  # bf16 reconstruct, relative L2 (tests/test_torch_port_amp.py)
OP = "san.grid_sample_fwd.default"
CONV_OP = "san.conv3x3.default"


def _targets(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


# ------------------------------------------------------------ the custom op
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("requires_grad", [False, True])
def test_opcheck(padding_mode, dtype, requires_grad):
    """Every case runs the schema, autograd-registration and fake-tensor
    checks. The AOT-dispatch check (eager against AOTAutograd's trace,
    forward and backward) runs in every case without gradients and, with
    gradients, once: f32 in zeros padding. It is 4 s a case on the CPU
    with a backward, and what it adds over the fake-tensor check does not
    depend on the padding mode or the image's dtype."""
    rng = np.random.default_rng(40)
    img = torch.from_numpy(rng.standard_normal((2, 2, 8, 6)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32))
    args = (img.to(dtype).requires_grad_(requires_grad),
            grid.requires_grad_(requires_grad), padding_mode)
    utils = ["test_schema", "test_autograd_registration", "test_faketensor"]
    if not requires_grad or (dtype == torch.float32 and padding_mode == "zeros"):
        utils.append("test_aot_dispatch_dynamic")
    torch.library.opcheck(kgs.grid_sample_op, args, test_utils=utils)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_cuda_tensors_trace_without_a_pointer(monkeypatch, dtype):
    """torch.export on the card traces the op on fake CUDA tensors: the
    result is a fake CUDA tensor of the output's shape in the image's type,
    and no kernel is built, loaded or launched, nor a pointer read."""
    def refuse(*args):
        raise AssertionError("a kernel was built or launched while tracing")

    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(kgs, "load", refuse)
    monkeypatch.setattr(kgs, "launch", refuse)
    kernels.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # "Accessing the data pointer of FakeTensor"
        with FakeTensorMode():
            img = torch.empty((2, 3, 16, 12), dtype=dtype, device="cuda")
            grid = torch.empty((2, 10, 14, 2), dtype=torch.float32, device="cuda")
            out = kgs.grid_sample_fwd(img, grid, "zeros")
            assert out.device.type == "cuda"
            assert tuple(out.shape) == (2, 3, 10, 14) and out.dtype == dtype
    assert not kernels.LAUNCHES


# ------------------------------------------------------------ export
@pytest.fixture(scope="module")
def saved_jax_model(tmp_path_factory):
    """A saved tiny JAX model whose STN head is non-zero, so the warp moves
    the reference (tests/test_torch_port_serve.py's fixture)."""
    jm = JaxCSModel(cfg=JaxConfig(**tiny_cfg().to_dict()), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jnp.asarray(np.array([0.05, -0.03], np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    jm.save(path)
    return jm, path


@pytest.fixture(scope="module")
def exported(saved_jax_model, tmp_path_factory):
    """The port's model from that checkpoint, exported at the batch shape
    of `_batch`: (model, artifact bytes, artifact path)."""
    _, path = saved_jax_model
    tm = CSModel(ckpt=path, device="cpu")
    artifact = str(tmp_path_factory.mktemp("export") / "recon.pt2")
    blob = export_reconstruct(tm, (2, 1, 16, 16), artifact)
    return tm, blob, artifact


def test_export_replays_the_live_path_and_jax(saved_jax_model, exported):
    jm, _ = saved_jax_model
    tm, blob, artifact = exported
    with open(artifact, "rb") as f:
        assert f.read() == blob
    full, aux = _batch(seed=7)
    live = tm.reconstruct(full, aux)
    want = np.asarray(jexport.load_exported(
        jexport.export_reconstruct(jm, full.shape))(jnp.asarray(full), jnp.asarray(aux)))
    for src in (blob, artifact):
        fn = load_exported(src)
        got = fn(torch.from_numpy(full), torch.from_numpy(aux))
        assert got.shape == (2, 1, 16, 16) and got.dtype == torch.float32
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), live.numpy(), **LIVE)
        np.testing.assert_allclose(got.numpy(), want, **SERVE)
    # another batch through the same artifact: nothing of the first is baked in
    full2, aux2 = _batch(seed=8)
    np.testing.assert_allclose(
        fn(torch.from_numpy(full2), torch.from_numpy(aux2)).numpy(),
        tm.reconstruct(full2, aux2).numpy(), **LIVE)


def test_the_graph_holds_the_op_once(exported):
    """The reloaded program samples through the custom op, once, and
    through no aten grid sampler."""
    targets = _targets(load_exported(exported[1]))
    assert targets.count(OP) == 1
    assert not [t for t in targets if "grid_sampler" in t]


def test_use_amp_export_keeps_the_f32_grid(tmp_path):
    jm = JaxCSModel(cfg=JaxConfig(**{**tiny_cfg().to_dict(), "use_amp": True}), seed=0)
    assert jm.dtype == jnp.bfloat16
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(6)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jnp.asarray(np.array([0.04, -0.03], np.float32))
    path = os.path.join(str(tmp_path), "amp")
    jm.save(path)
    tm = CSModel(ckpt=path, device="cpu")
    assert tm.dtype == torch.bfloat16
    full, aux = _batch(seed=9)
    fn = load_exported(export_reconstruct(tm, full.shape))
    (node,) = [n for n in fn.graph.nodes if str(n.target) == OP]
    assert node.args[1].meta["val"].dtype == torch.float32  # the grid
    got = fn(torch.from_numpy(full), torch.from_numpy(aux))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), tm.reconstruct(full, aux).numpy(), **LIVE)
    want = np.asarray(jm.reconstruct(full, aux))
    err = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    assert err <= RECON_BAR, f"bf16 replay {err:.3g} from JAX's > {RECON_BAR}"


# ------------------------------------------------------------ the conv route's op
@pytest.mark.parametrize("requires_grad", [False, True])
def test_conv3x3_opcheck(requires_grad):
    """Schema, autograd registration, fake tensors and AOT dispatch
    (eager against AOTAutograd's trace, forward and backward) of
    `san::conv3x3` in f32."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 3)).astype(np.float32))
    w3 = torch.from_numpy((rng.standard_normal((3, 3, 3, 5)) * 0.2).astype(np.float32))
    torch.library.opcheck(kconv.conv3x3_op, (x.requires_grad_(requires_grad),
                                             w3.requires_grad_(requires_grad)),
                          test_utils=["test_schema", "test_autograd_registration",
                                      "test_faketensor", "test_aot_dispatch_dynamic"])


def test_conv3x3_on_fake_cuda_tensors_traces_without_a_pointer(monkeypatch):
    """The op on fake CUDA tensors, as torch.export traces it on the card:
    a fake CUDA [N, H, W, Cout] f32 result, and no kernel built, loaded or
    launched, nor a pointer read."""
    def refuse(*args):
        raise AssertionError("a kernel was built or launched while tracing")

    monkeypatch.setattr(kernels, "build", refuse)
    monkeypatch.setattr(kconv, "load", refuse)
    monkeypatch.setattr(kconv, "launch", refuse)
    kernels.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # "Accessing the data pointer of FakeTensor"
        with FakeTensorMode():
            x = torch.empty((2, 16, 12, 18), device="cuda")
            w3 = torch.empty((3, 3, 18, 7), device="cuda")
            out = kconv.conv3x3_s2d(x, w3)
            assert out.device.type == "cuda"
            assert tuple(out.shape) == (2, 16, 12, 7) and out.dtype == torch.float32
    assert not kernels.LAUNCHES


def test_export_with_the_conv_route_holds_the_op_once_a_conv(saved_jax_model, monkeypatch):
    """With the route engaged (forced on CPU tensors, where it otherwise
    stays off), the exported recon step holds `san::conv3x3` once for each
    ConvBlock conv of net_R (both U-Nets), and its replay gives the live
    path's output; both within f32 rounding of the unrouted path."""
    _, path = saved_jax_model
    tm = CSModel(ckpt=path, device="cpu")
    full, aux = _batch(seed=10)
    unrouted = tm.reconstruct(full, aux)
    monkeypatch.setattr(Conv3x3, "routed", lambda self, x: True)
    routed = sum(isinstance(m, Conv3x3) for m in tm.net_R.modules())
    assert routed == 12  # 2 U-Nets of 1 pool: 3 ConvBlocks each
    fn = load_exported(export_reconstruct(tm, full.shape))
    targets = _targets(fn)
    assert targets.count(CONV_OP) == routed and targets.count(OP) == 1
    live = tm.reconstruct(full, aux)
    got = fn(torch.from_numpy(full), torch.from_numpy(aux))
    np.testing.assert_allclose(got.numpy(), live.numpy(), **LIVE)
    np.testing.assert_allclose(live.numpy(), unrouted.numpy(), rtol=1e-4, atol=1e-5)
