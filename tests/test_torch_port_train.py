"""The PyTorch port's Rec and None train steps against the JAX package, on
the CPU.

A tiny JAX CSModel (2 cascades, non-zero STN head so the warp moves the
reference by sub-pixel amounts) is saved; the port loads the checkpoint,
so both start from the same weights, BatchNorm statistics and mask. Then:

  * step 0: the losses, and every gradient of the regime's nets against
    `jax.grad` of the JAX package's `_regime_loss`. Tolerance: 1e-3 of the
    leaf's largest gradient plus 1e-6 of the net's. The second term is a
    noise floor: a conv bias that a BatchNorm follows has an exact
    gradient of 0 (the norm removes it) and a dc_weight's gradient is a
    sum that cancels, so both frameworks give rounding noise there.
  * 3 `update()`s against 3 JAX `update()`s: losses (rtol 1e-4), the
    parameters to the Adam bar of tests/test_train_step_parity.py (Adam's
    first steps move every element by about +-lr whatever the gradient's
    size, so sign noise shows: mean |diff| < 0.7 lr n, max < 2.5 lr n; the
    noise-driven biases above get the max bar only), and net_T's running
    statistics (rtol 1e-4; a running mean takes 0.1 of its conv bias each
    step, so it also carries that bias's noise: atol lr).
  * checkpoints both ways: the port's save loads in the JAX CSModel, and a
    JAX `save(with_opt=True)` resumes in the port with Adam's moments; the
    port's `save(with_opt=True)` of it, or of a model built from a cfg,
    loads in the JAX CSModel with every optimizer key, and net_G / net_D
    go through the port's modules on load-then-save bit for bit.
  * `grad_accum=2` on rows whose micro-batches repeat the full batch takes
    the full-batch step; an unknown regime and a GAN regime at batch 1 are
    refused, not silently run; a LOUPE checkpoint without learn_mask
    trains with its mask fixed (mask learning itself:
    tests/test_torch_port_mask_learning.py).
  * `chip_smoke.py`'s train, autograd and GAN phases run on the CPU.

Inputs come from numpy seeds.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.engine.checkpoint import ckpt_load as jckpt_load
from spatialalignmentnetwork_tpu.engine.checkpoint import flatten_tree
from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.engine.csmodel import GRAD_NETS

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine import from_jax
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
from spatialalignmentnetwork_tpu_torch.models.unet_lib import ConvBNAct

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
STEPS = 3


def _cfg(reg):
    """tests/test_torch_port_serve.py::tiny_cfg with two cascades."""
    return Config(
        sparsity=0.25, lr=LR, shape=16, coils=1, reg=reg,
        mask="equispaced", weight_smooth=1000.0, weight_gan=0.1,
        weight_gan_sim=1.0, weight_sim=1.0, net_G_layers=(4, 8),
        net_D_blocks=((4,), (8,)), net_T_layers=(4, 8), net_R_cascades=2,
        net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
        net_R_sens_pools=1,
    )


def _batch(seed, n=2, shape=16):
    rng = np.random.default_rng(100 + seed)
    mk = lambda: (rng.random((n, 1, shape, shape))
                  + 1j * rng.random((n, 1, shape, shape))).astype(np.complex64)
    return mk(), mk()


def _copy(state):
    # a JAX update donates its state: keep an independent copy
    return jax.tree_util.tree_map(jnp.array, state)


def _jax_entry(state, coll, name):
    return {f"{coll}/{k}": np.asarray(v)
            for k, v in flatten_tree(state[coll][name]).items()}


def _port_params(tm, name, tensors=None):
    """A port net's parameters (or per-parameter `tensors`) as a JAX
    entry {'params/...': array}."""
    net = getattr(tm, name)
    if tensors is None:
        tensors = dict(net.named_parameters())
    entries = [e for e in tm._entries(name) if e[1].startswith("params/")]
    return from_jax.to_jax_entries(tensors, entries)


def _bn_biases(tm) -> set:
    """JAX keys of the net_T conv biases that a BatchNorm follows."""
    names = {f"{n}.conv.bias" for n, m in tm.net_T.named_modules()
             if isinstance(m, ConvBNAct)}
    return {j for t, j, _, _ in from_jax.stn_entries(tm.net_T) if t in names}


def _assert_adam_bar(got, want, n, noise_keys=(), what=""):
    for key, w in want.items():
        diff = np.abs(np.asarray(got[key], np.float32) - w)
        assert float(diff.max()) < 2.5 * LR * n, f"{what} {key}: max {diff.max():.2e}"
        if key not in noise_keys:
            assert float(diff.mean()) < 0.7 * LR * n, (
                f"{what} {key}: mean {diff.mean():.2e}")


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A saved tiny JAX model and a copy of its state."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("Rec").to_dict()), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05
    )
    head["bias"] = jnp.asarray(np.array([0.05, -0.03], np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "start")
    jm.save(path)
    return jm, _copy(jm.state), path


@pytest.fixture(scope="module", params=["Rec", "None"])
def run(request, start):
    """Step-0 gradients and 3 updates of one regime, in both packages."""
    regime = request.param
    jm, state0, path = start
    jm.cfg.reg = regime
    jm.state = _copy(state0)
    tm = CSModel(ckpt=path, cfg=_cfg(regime), device="cpu")

    full, aux = _batch(0)
    env = jm._prepare(jnp.asarray(full), jnp.asarray(aux), jm.state["pruned"])
    params = jm.state["params"]

    def loss_fn(train_params):
        total, losses, _, _ = jm._regime_loss(
            {**params, **train_params}, jm.state["stats"], env, regime
        )
        return total, losses

    grads, jax_loss0 = jax.jit(jax.grad(loss_fn, has_aux=True))(
        {k: params[k] for k in GRAD_NETS[regime]}
    )
    out = {
        "regime": regime, "tm": tm,
        "jax_grads": {name: {f"params/{k}": np.asarray(v)
                             for k, v in flatten_tree(grads[name]).items()}
                      for name in grads},
        "jax_loss0": {k: float(v) for k, v in jax_loss0.items()},
        "jax_losses": [], "port_losses": [],
    }
    kernels.reset_launches()
    for step in range(STEPS):
        full, aux = _batch(step)
        tm.set_input(full, aux)
        tm.update()
        if step == 0:
            out["port_grads"] = {
                name: _port_params(tm, name, {
                    k: p.grad for k, p in getattr(tm, name).named_parameters()
                })
                for name in GRAD_NETS[regime]
            }
            out["net_T_grad0"] = [p.grad for p in tm.net_T.parameters()]
        out["port_losses"].append(tm.get_vis("scalars")["scalars"])
        jm.set_input(full, aux)
        jm.update()
        out["jax_losses"].append(jm.get_vis("scalars")["scalars"])
    out["launches"] = dict(kernels.LAUNCHES)
    out["jax_state"] = jm.state
    return out


def test_step0_losses_and_gradients_match_jax(run):
    assert set(run["port_grads"]) == set(GRAD_NETS[run["regime"]])
    assert set(run["port_losses"][0]) == {"loss_all", "loss_sim", "loss_smooth"}
    for k, v in run["jax_loss0"].items():
        np.testing.assert_allclose(run["port_losses"][0][k], v, rtol=1e-5, err_msg=k)
    for name, want in run["jax_grads"].items():
        got = run["port_grads"][name]
        assert got.keys() == want.keys()
        net_max = max(float(np.abs(w).max()) for w in want.values())
        for key, w in want.items():
            err = float(np.abs(got[key] - w).max())
            assert err <= 1e-3 * float(np.abs(w).max()) + 1e-6 * net_max, (
                f"{name} {key}: {err:.3g}, leaf max {np.abs(w).max():.3g}, "
                f"net max {net_max:.3g}")
    if run["regime"] == "None":  # the grid is detached: no gradient into net_T
        assert all(g is None for g in run["net_T_grad0"])


def test_three_updates_match_jax(run):
    tm, jstate = run["tm"], run["jax_state"]
    for step, (got, want) in enumerate(zip(run["port_losses"], run["jax_losses"])):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    noise = _bn_biases(tm)
    for name in ("net_T", "net_R"):
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jstate, "params", name),
                         STEPS, noise, f"{run['regime']} {name}")
    sd = tm.net_T.state_dict()
    want = _jax_entry(jstate, "stats", "net_T")
    for tkey, jkey, _, _ in from_jax.stn_entries(tm.net_T):
        if jkey.startswith("stats/"):
            np.testing.assert_allclose(sd[tkey].numpy(), want[jkey], rtol=1e-4,
                                       atol=LR if jkey.endswith("/mean") else 0.0,
                                       err_msg=jkey)
    assert run["launches"] == {}  # CPU tensors take the plain versions


def test_regimes_outside_the_slice_raise(tmp_path):
    """An unknown regime, and a GAN regime at batch 1 (forwardG would halve
    it into an empty half), raise before anything moves; so do a step out
    of train mode and an lr other than the recipe's."""
    tm = CSModel(cfg=_cfg("Mixed"), device="cpu")
    before = [p.detach().clone() for p in tm.net_G.parameters()]
    tm.set_input(*_batch(0, n=1))
    with pytest.raises(ValueError, match="forwardG crossover"):
        tm.update()
    assert all(torch.equal(a, p) for a, p in zip(before, tm.net_G.parameters()))
    tm.cfg.reg = "Supervised"
    tm.set_input(*_batch(0))
    with pytest.raises(ValueError, match="unknown regime"):
        tm.update()
    tm.cfg.reg = "Rec"
    tm.eval()
    with pytest.raises(RuntimeError, match="train mode"):
        tm.update()
    with pytest.raises(ValueError, match="lr"):
        CSModel(cfg=Config(**{**_cfg("Rec").to_dict(), "lr": 1e-3}), device="cpu")


def test_port_checkpoint_loads_in_jax(start, tmp_path):
    """After one port step (net_T and its statistics moved), the port's
    checkpoint loads in the JAX CSModel and reconstructs as the port does
    (the serving bar: rtol 1e-3, atol 1e-4)."""
    _, _, path = start
    tm = CSModel(ckpt=path, cfg=_cfg("Rec"), device="cpu")
    tm.set_input(*_batch(0))
    tm.update()
    out = str(tmp_path / "port")
    tm.save(out)
    jm = JaxCSModel(ckpt=out)
    loaded = jckpt_load(out)
    np.testing.assert_array_equal(np.asarray(jm.state["pruned"]), tm.pruned.numpy())
    for name in ("net_T", "net_R"):
        got = _port_params(tm, name)
        for key, v in got.items():
            np.testing.assert_array_equal(loaded[name][key], v)
    full, aux = _batch(7)
    np.testing.assert_allclose(
        tm.reconstruct(full, aux).numpy(), np.asarray(jm.reconstruct(full, aux)),
        rtol=1e-3, atol=1e-4,
    )


@pytest.fixture(scope="module")
def jax_opt(start, tmp_path_factory):
    """A JAX `save(with_opt=True)` after one Rec step, and the JAX state
    it holds."""
    jm, state0, _ = start
    jm.cfg.reg = "Rec"
    jm.state = _copy(state0)
    jm.set_input(*_batch(0))
    jm.update()
    path = str(tmp_path_factory.mktemp("jax_opt") / "ckpt")
    jm.save(path, with_opt=True)
    return path, _copy(jm.state)


def test_jax_checkpoint_with_opt_resumes_in_port(start, jax_opt, tmp_path):
    """A JAX `save(with_opt=True)` after one step: the port restores
    Adam's moments and step exactly (and saves them back with every other
    net's optimizer keys as loaded), and its next step matches the JAX
    next step (the Adam bar with n = 1)."""
    jm = start[0]
    path, state1 = jax_opt
    jm.cfg.reg = "Rec"
    jm.state = _copy(state1)
    tm = CSModel(ckpt=path, cfg=_cfg("Rec"), device="cpu")
    back = str(tmp_path / "port_opt")
    tm.save(back, with_opt=True)
    want, got = jckpt_load(path)["opt_state"], jckpt_load(back)["opt_state"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    full, aux = _batch(1)
    tm.set_input(full, aux)
    tm.update()
    jm.set_input(full, aux)
    jm.update()
    for k, v in jm.get_vis("scalars")["scalars"].items():
        np.testing.assert_allclose(tm.get_vis("scalars")["scalars"][k], v,
                                   rtol=1e-4, err_msg=k)
    for name in ("net_T", "net_R"):
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jm.state, "params", name),
                         1, _bn_biases(tm), f"resumed {name}")


def test_port_save_with_opt_after_a_step_loads_in_jax(start, jax_opt, tmp_path):
    """JAX `save(with_opt=True)` -> port load -> one port step -> port
    `save(with_opt=True)`: the JAX CSModel loads it (its `load` asserts
    that no optimizer key is missing). Every `opt_state` key is there, each
    the port's own: net_T's and net_R's moments after its step, net_G's and
    net_D's as loaded, net_mask's count (a fixed mask has no weight); the
    JAX model restores them exactly."""
    from flax import serialization

    path, _ = jax_opt
    tm = CSModel(ckpt=path, cfg=_cfg("Rec"), device="cpu")
    tm.set_input(*_batch(1))
    tm.update()
    out = str(tmp_path / "port_opt_step")
    tm.save(out, with_opt=True)
    want = jckpt_load(path)["opt_state"]
    got = jckpt_load(out)["opt_state"]
    ours = tm._opt_entries()
    assert set(got) == set(want) == set(ours)
    for k in want:
        np.testing.assert_array_equal(got[k], ours[k], err_msg=k)
    assert int(ours["net_T/0/count"]) == 2  # the JAX step, then the port's
    jm = JaxCSModel(ckpt=out)
    restored = flatten_tree(serialization.to_state_dict(jm.state["opt"]))
    assert set(restored) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v, err_msg=k)


def test_load_then_save_keeps_net_g_and_net_d(start, tmp_path):
    """A JAX checkpoint's net_G and net_D load into the port's modules
    (params, BatchNorm statistics, u and v) and come back from a port
    load-then-save bit for bit."""
    jm, _, path = start
    tm = CSModel(ckpt=path, cfg=_cfg("Rec"), device="cpu")
    out = str(tmp_path / "port_resaved")
    tm.save(out)
    want, got = jckpt_load(path), jckpt_load(out)
    for name in ("net_G", "net_D"):
        assert set(got[name]) == set(want[name]) and want[name], name
        sd = {k: v for k, v in getattr(tm, name).state_dict().items()
              if not k.endswith("num_batches_tracked")}
        held = from_jax.to_jax_entries(sd, tm._entries(name))
        assert set(held) == set(want[name]), name  # every array is in the module
        for k, v in want[name].items():
            assert got[name][k].dtype == v.dtype, f"{name} {k}"
            np.testing.assert_array_equal(held[k], v, err_msg=f"{name} {k}")
            np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name} {k}")
    assert set(got["net_mask"]) == {"pruned"}


def test_save_with_opt_without_a_checkpoint_is_refused(tmp_path):
    """A model built from a cfg (no checkpoint) saves its optimizer state
    too, after a Mixed step: the JAX CSModel loads it (its `load` asserts
    that no optimizer key is missing or extra, net_mask's included) and
    restores every moment and count exactly."""
    from flax import serialization

    tm = CSModel(cfg=_cfg("Mixed"), device="cpu")
    tm.set_input(*_batch(0))
    tm.update()
    out = str(tmp_path / "fresh")
    tm.save(out, with_opt=True)
    saved = jckpt_load(out)["opt_state"]
    jm = JaxCSModel(ckpt=out)
    restored = flatten_tree(serialization.to_state_dict(jm.state["opt"]))
    assert set(restored) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v, err_msg=k)
    assert {k: int(saved[f"{k}/0/count"]) for k in
            ("net_G", "net_D", "net_T", "net_R", "net_mask")} == {
        "net_G": 1, "net_D": 1, "net_T": 1, "net_R": 1, "net_mask": 0}


def test_grad_accum_is_refused():
    """grad_accum=2 on a batch whose micro-batches each repeat the full
    batch's rows ([a, b, a, b] in Rec: micro-batches [a, b] and [a, b]) has
    the full-batch step's losses and gradients, as the JAX package's
    accumulation does (tests/test_engine.py): equal means, equal BatchNorm
    batch statistics. Gradients at rtol 2e-4 and atol 1e-6 of the net's
    largest (sums in another order); the JAX package is held in
    tests/test_torch_port_gan_accum.py."""
    full2, aux2 = _batch(0)
    rep = lambda x: np.concatenate([x, x])
    tms = {}
    for accum in (1, 2):
        tm = CSModel(cfg=Config(**{**_cfg("Rec").to_dict(), "grad_accum": accum}),
                     device="cpu", seed=3)
        tm.set_input(rep(full2), rep(aux2))
        tm.update()
        tms[accum] = tm
    la, lb = (tms[a].get_vis("scalars")["scalars"] for a in (1, 2))
    for k, v in la.items():
        np.testing.assert_allclose(lb[k], v, rtol=1e-5, err_msg=k)
    for name in ("net_T", "net_R"):
        ga = [p.grad for p in getattr(tms[1], name).parameters()]
        gb = [p.grad for p in getattr(tms[2], name).parameters()]
        net_max = max(float(g.abs().max()) for g in ga)
        for a, b in zip(ga, gb):
            torch.testing.assert_close(b, a, rtol=2e-4, atol=1e-6 * net_max)


def test_a_loupe_checkpoint_without_learn_mask_still_trains(start):
    """A checkpoint of a fixed mask loaded with cfg.mask "loupe" and no
    learn_mask: the step trains the nets with the checkpoint's `pruned`
    fixed, and the fresh LOUPE logits stay where they were."""
    _, _, path = start
    loupe = {**_cfg("Rec").to_dict(), "mask": "loupe"}
    tm = CSModel(ckpt=path, cfg=Config(**loupe, learn_mask=False), device="cpu")
    pruned, logits = tm.pruned.clone(), tm.net_mask.weight.detach().clone()
    before = [p.detach().clone() for p in tm.net_T.parameters()]
    tm.set_input(*_batch(0))
    tm.update()
    assert torch.equal(tm.pruned, pruned)
    assert torch.equal(tm.net_mask.weight.detach(), logits)
    assert not all(torch.equal(a, p) for a, p in zip(before, tm.net_T.parameters()))


def test_chip_smoke_train_and_autograd_phases_run_on_cpu():
    """chip_smoke.py's train-step, autograd and whole-step phases on the CPU
    at a small shape (full widths): their logic is exercised here, their
    numbers only on a card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    launches = chip_smoke.check_train(
        np.random.default_rng(0), device="cpu", shape=32, batch=2
    )
    assert launches == {}  # CPU tensors take the plain versions
    assert chip_smoke.check_autograd(
        np.random.default_rng(1), device="cpu", shape=32, batch=2
    ) == {}
    chip_smoke.check_train_vs_cpu(np.random.default_rng(2), device="cpu", shape=32)


def test_chip_smoke_step_check_holds_ill_conditioned_sensitivity_leaves(
        monkeypatch, capsys):
    """On a draw whose sensitivity maps come below SENS_MIN, chip_smoke.py's
    whole-step check names net_R's sensitivity-net leaves, logs them apart
    and holds them to SENS_ILL_TOL, the rest to STEP_GRAD_TOL; a bar of 0
    on those leaves fails."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    monkeypatch.setattr(chip_smoke, "SENS_MIN", float("inf"))  # every draw
    chip_smoke.check_train_vs_cpu(np.random.default_rng(2), device="cpu", shape=32)
    out = capsys.readouterr().out
    assert "sensitivity-net leaves, ill-conditioned" in out
    rest = next(line for line in out.splitlines() if line.startswith("Rec gradients"))
    assert "sens_net." not in rest
    monkeypatch.setattr(chip_smoke, "SENS_ILL_TOL", 0.0)
    with pytest.raises(AssertionError, match="net_R: cpu gradients differ"):
        chip_smoke.check_train_vs_cpu(np.random.default_rng(2), device="cpu", shape=32)


def test_chip_smoke_gan_phases_run_on_cpu():
    """chip_smoke.py's GAN phases on the CPU at a small shape (full widths):
    the Mixed recipe from PBSpline-augmented batches, one GAN-Only step and
    one accumulated Mixed step, augmentation against itself, and the whole
    Mixed step against float64."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    rng = np.random.default_rng(3)
    assert chip_smoke.check_mixed(rng, device="cpu", shape=32, batch=2) == {}
    assert chip_smoke.check_gan_only_and_accum(rng, device="cpu", shape=32, batch=4) == {}
    assert chip_smoke.check_augment(rng, device="cpu", shape=35, batch=2) == {}
    chip_smoke.check_train_vs_cpu(rng, device="cpu", shape=32, reg="Mixed")
    # the launch counts a card must show: one Mixed step's and one PBSpline
    # batch's, as the module derives them
    assert chip_smoke.add_counts(chip_smoke.MIXED_LAUNCHES, chip_smoke.PBSPLINE_LAUNCHES) == {
        "grid_sample_fwd": 4, "grid_sample_bwd_dgrid": 2, "grid_sample_bwd_dimg": 1,
        "ssim_fwd": 1, "ssim_bwd": 1}
