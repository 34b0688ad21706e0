"""The PyTorch port's Mixed and GAN-Only train steps against the JAX
package, on the CPU.

A tiny JAX CSModel (net_G (4, 8), net_D ((4,), (8,)), 2 cascades, a
non-zero STN head so the warp moves the reference by sub-pixel amounts)
is saved; the port loads the checkpoint, so both start from the same
weights, BatchNorm statistics, spectral-norm vectors and mask. Then, for
each GAN regime:

  * step 0: the losses (rtol 1e-5), every gradient of the regime's nets
    against `jax.grad` of the JAX package's `_regime_loss`, and net_D's
    against `jax.grad` of its `_d_phase_loss_fn` on the G-phase's fake;
    net_D's step takes the D-phase's gradients alone. The bar, a leaf's:
    1e-3 of its largest gradient plus 1e-6 of the net's (the bar of
    tests/test_torch_port_train.py; the second term is the noise floor of a
    conv bias that a BatchNorm follows, whose exact gradient is 0), taken
    from JAX's gradient in float64. Both packages also take the step in
    float64 (JAX with x64 enabled and its nets' flax dtype float64), and
    the port's float64 gradient must lie within the bar of JAX's. In f32,
    the port's gradient must lie within the bar of its own float64 one,
    and within the bar plus the JAX f32 gradient's own distance from JAX's
    float64 of the JAX f32 gradient. That distance matters where the JAX
    package computes a norm's variance in one pass (E[x^2] - E[x]^2): on
    net_G's first BatchNorm, over the raw reference image, its f32
    gradient lands over the bar from float64, the port's well within it
    (the assertion message prints both distances). A planted fault
    (net_D's D-phase without weight_gan, or net_G's gan_sim term doubled)
    must fail these checks.
  * 3 `update()`s against 3 JAX `update()`s: the losses (rtol 1e-4; the
    adversarial losses, means of patch scores of both signs that cancel to
    about 1e-3 of the scores, also atol 1e-6), every
    net's parameters at the Adam bar of tests/test_torch_port_train.py,
    and net_G's and net_D's statistics: BatchNorm running statistics (rtol
    1e-4, atol lr), u and v (atol 1e-3: unit vectors of a power iteration
    on weights that the two packages' Adam steps leave up to 2.5 lr n
    apart).
  * checkpoints both ways with every net's optimizer state: the port's
    `save(with_opt=True)` after its updates loads in the JAX CSModel, and
    the JAX one's resumes in the port for one more matching step.

A GAN regime at batch 1 raises in both packages. Inputs from numpy seeds.
"""

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
from spatialalignmentnetwork_tpu_torch.models.gan import SNConv
from spatialalignmentnetwork_tpu_torch.models.unet_lib import ConvBNAct

torch.set_num_threads(2)
LR = 1e-4
STEPS = 3
SN_ATOL = 1e-3
NETS = ("net_G", "net_D", "net_T", "net_R")
GAN_LOSSES = ("loss_gan_G", "loss_gan_Dfake", "loss_gan_Dreal")


def _cfg(reg, **extra):
    """tests/test_torch_port_train.py's tiny configuration."""
    return Config(**{
        **dict(sparsity=0.25, lr=LR, shape=16, coils=1, reg=reg,
               mask="equispaced", weight_smooth=1000.0, weight_gan=0.1,
               weight_gan_sim=1.0, weight_sim=1.0, net_G_layers=(4, 8),
               net_D_blocks=((4,), (8,)), net_T_layers=(4, 8), net_R_cascades=2,
               net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
               net_R_sens_pools=1),
        **extra,
    })


def _batch(seed, n=2, shape=16):
    rng = np.random.default_rng(200 + seed)
    mk = lambda: (rng.random((n, 1, shape, shape))
                  + 1j * rng.random((n, 1, shape, shape))).astype(np.complex64)
    return mk(), mk()


def _copy(state):
    return jax.tree_util.tree_map(jnp.array, state)


def _jax_entry(state, coll, name):
    return {f"{coll}/{k}": np.asarray(v)
            for k, v in flatten_tree(state[coll][name]).items()}


def _port_entry(tm, name, tensors, coll="params/"):
    entries = [e for e in tm._entries(name) if e[1].startswith(coll)]
    return from_jax.to_jax_entries(tensors, entries)


def _port_params(tm, name):
    return _port_entry(tm, name, dict(getattr(tm, name).named_parameters()))


def _port_stats(tm, name):
    sd = getattr(tm, name).state_dict()
    keys = {e[0] for e in tm._entries(name) if e[1].startswith("stats/")}
    return _port_entry(tm, name, {k: sd[k] for k in keys}, "stats/")


def _noise_keys(tm) -> set:
    """JAX keys of conv biases that a BatchNorm follows (exact gradient 0
    in train mode): net_T's ConvBNAct convs, and the SpectralConv of each
    net_G SNConv whose output feeds another SNConv's BatchNorm."""
    keys = set()
    names = {f"{n}.conv.bias" for n, m in tm.net_T.named_modules()
             if isinstance(m, ConvBNAct)}
    keys |= {j for t, j, _, _ in tm._entries("net_T") if t in names}
    # every net_G conv but the last feeds a BatchNorm (directly or through
    # a residual sum or a concat)
    last = [n for n, m in tm.net_G.named_modules() if isinstance(m, SNConv)][-1]
    keys |= {j for t, j, _, _ in tm._entries("net_G")
             if t.endswith("conv.bias") and not t.startswith(last + ".")}
    return keys


def _assert_adam_bar(got, want, n, noise_keys=(), what=""):
    for key, w in want.items():
        diff = np.abs(np.asarray(got[key], np.float32) - w)
        assert float(diff.max()) < 2.5 * LR * n, f"{what} {key}: max {diff.max():.2e}"
        if key not in noise_keys:
            assert float(diff.mean()) < 0.7 * LR * n, (
                f"{what} {key}: mean {diff.mean():.2e}")


def _assert_grads(got, want, got64, want64, what):
    """The port's gradients (`got` in f32, `got64` in float64) against
    JAX's (`want`, `want64`), leaf by leaf, at the bar of the module
    docstring."""
    assert got.keys() == want.keys() == got64.keys() == want64.keys(), what
    net_max = max(float(np.abs(w).max()) for w in want64.values())
    for key, ref in want64.items():
        bar = 1e-3 * float(np.abs(ref).max()) + 1e-6 * net_max
        e64 = float(np.abs(got64[key] - ref).max())
        e_port = float(np.abs(got[key] - got64[key]).max())
        e_jax = float(np.abs(want[key] - ref).max())
        err = float(np.abs(got[key] - want[key]).max())
        assert e64 <= bar and e_port <= bar and err <= bar + e_jax, (
            f"{what} {key}: port-jax f64 {e64:.3g}, port f32-f64 {e_port:.3g}, "
            f"port-jax f32 {err:.3g}, jax f32-f64 {e_jax:.3g}, bar {bar:.3g}")


def _assert_losses(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-6 if k in GAN_LOSSES else 0.0,
                                   err_msg=f"{what} {k}")


def _port_grads(path, cfg, full, aux, f64=True):
    """The port's first-step gradients of every net it steps, as JAX
    entries; in float64 (the warp's plain version reads its grid in f32)
    or f32."""
    tm = CSModel(ckpt=path, cfg=cfg, device="cpu")
    if f64:
        for name in NETS:
            getattr(tm, name).to(torch.float64)
        tm._batch = (torch.from_numpy(full).to(torch.complex128),  # set_input takes complex64
                     torch.from_numpy(aux).to(torch.complex128))
    else:
        tm.set_input(full, aux)
    tm.update()
    return {name: _port_entry(tm, name, {k: p.grad for k, p in
                                         getattr(tm, name).named_parameters()})
            for name in NETS if next(getattr(tm, name).parameters()).grad is not None}


def _assert_stats(tm, jstate, what, names=("net_G", "net_D")):
    """BatchNorm running mean and variance (rtol 1e-4, atol lr on a mean),
    and the spectral-norm vectors (atol SN_ATOL)."""
    for name in names:
        got, want = _port_stats(tm, name), _jax_entry(jstate, "stats", name)
        assert got.keys() == want.keys(), name
        for key, w in want.items():
            if key.endswith(("/u", "/v")):
                np.testing.assert_allclose(got[key], w, atol=SN_ATOL,
                                           err_msg=f"{what} {key}")
            else:
                np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                           atol=LR if key.endswith("/mean") else 0.0,
                                           err_msg=f"{what} {name} {key}")


def _jax_f64(path, cfg):
    """The JAX CSModel of checkpoint `path` taking its steps in float64:
    its nets with flax dtype float64 and its state cast up. Use it under
    `jax.enable_x64(True)`."""
    with jax.enable_x64(False):  # its build traces f32 inits
        jm = JaxCSModel(ckpt=path, cfg=JaxConfig(**cfg.to_dict()))
    for name in ("net_G", "net_D", "net_T", "net_R", "net_R_train"):
        setattr(jm, name, getattr(jm, name).clone(dtype=jnp.float64))
    up = {jnp.dtype(jnp.float32): jnp.float64, jnp.dtype(jnp.complex64): jnp.complex128}
    with jax.enable_x64(True):
        jm.state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, up.get(jnp.asarray(x).dtype)), jm.state)
    return jm


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A saved tiny JAX model and a copy of its state."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("Mixed").to_dict()), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(6)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jnp.asarray(np.array([0.04, -0.03], np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "start")
    jm.save(path)
    return jm, _copy(jm.state), path


def _jax_step0(jm, regime, full, aux):
    """jax.grad of the G-phase loss for the regime's nets and of the
    D-phase loss for net_D, on the JAX model's state."""
    state = jm.state
    env = jm._prepare(jnp.asarray(full), jnp.asarray(aux), state["pruned"])
    params, stats = state["params"], state["stats"]

    def fn(train_params, params_D):
        def loss_fn(tp):
            total, losses, imgs, new_stats = jm._regime_loss(
                {**params, **tp}, stats, env, regime)
            return total, (losses, imgs, new_stats)

        grads, (losses, imgs, new_stats) = jax.grad(loss_fn, has_aux=True)(train_params)
        loss_fn_D = jm._d_phase_loss_fn(imgs["img_aligned"], env["img_full_rss"],
                                        new_stats["net_D"])
        g_d, (lf, lr, _) = jax.grad(loss_fn_D, has_aux=True)(params_D)
        return grads, g_d, {**losses, "loss_gan_Dfake": lf, "loss_gan_Dreal": lr}

    grads, g_d, losses = jax.jit(fn)({k: params[k] for k in GRAD_NETS[regime]},
                                     params["net_D"])
    out = {name: {f"params/{k}": np.asarray(v) for k, v in flatten_tree(grads[name]).items()}
           for name in grads}
    out["net_D"] = {f"params/{k}": np.asarray(v) for k, v in flatten_tree(g_d).items()}
    return out, {k: float(v) for k, v in losses.items()}


@pytest.fixture(scope="module", params=["Mixed", "GAN-Only"])
def run(request, start, tmp_path_factory):
    """Step-0 gradients and 3 updates of one GAN regime in both packages;
    then each side's checkpoint with its optimizer state."""
    regime = request.param
    jm, state0, path = start
    jm.cfg.reg = regime
    jm.state = _copy(state0)
    tm = CSModel(ckpt=path, cfg=_cfg(regime), device="cpu")
    out = {"regime": regime, "path": path, "tm": tm, "jm": jm, "jax_losses": [],
           "port_losses": []}
    full0, aux0 = _batch(0)
    out["jax_grads"], out["jax_loss0"] = _jax_step0(jm, regime, full0, aux0)
    with jax.enable_x64(True):
        out["jax_grads64"], _ = _jax_step0(_jax_f64(path, _cfg(regime)), regime,
                                           full0.astype(np.complex128),
                                           aux0.astype(np.complex128))
    out["port_grads64"] = _port_grads(path, _cfg(regime), full0, aux0)
    kernels.reset_launches()
    for step in range(STEPS):
        full, aux = _batch(step)
        tm.set_input(full, aux)
        tm.update()
        if step == 0:
            out["port_grads"] = {
                name: _port_entry(tm, name, {k: p.grad for k, p in
                                             getattr(tm, name).named_parameters()})
                for name in GRAD_NETS[regime] + ("net_D",)}
            out["untouched"] = [p.grad for name in NETS
                                if name not in GRAD_NETS[regime] + ("net_D",)
                                for p in getattr(tm, name).parameters()]
        out["port_losses"].append(tm.get_vis("scalars")["scalars"])
        jm.set_input(full, aux)
        jm.update()
        out["jax_losses"].append(jm.get_vis("scalars")["scalars"])
    out["launches"] = dict(kernels.LAUNCHES)
    out["jax_state"] = _copy(jm.state)
    ckpts = tmp_path_factory.mktemp(f"opt_{regime}")
    out["port_ckpt"] = str(ckpts / "port")
    tm.save(out["port_ckpt"], with_opt=True)
    out["jax_ckpt"] = str(ckpts / "jax")
    jm.save(out["jax_ckpt"], with_opt=True)
    return out


def test_step0_losses_and_gradients_match_jax(run):
    """The G-phase's gradients of the regime's nets and net_D's D-phase
    gradients; no other net gets a gradient."""
    regime = run["regime"]
    assert set(run["port_grads"]) == set(GRAD_NETS[regime]) | {"net_D"}
    want_keys = {"loss_all", "loss_smooth", "loss_gan_sim", "loss_gan_G",
                 "loss_gan_Dfake", "loss_gan_Dreal"} | (
        {"loss_sim"} if regime == "Mixed" else set())
    assert set(run["port_losses"][0]) == want_keys == set(run["jax_loss0"])
    for k, v in run["jax_loss0"].items():
        np.testing.assert_allclose(run["port_losses"][0][k], v, rtol=1e-5, err_msg=k)
    assert set(run["port_grads64"]) == set(run["jax_grads"]) == set(run["jax_grads64"])
    assert {v.dtype for g in run["jax_grads64"].values() for v in g.values()} == {
        np.dtype(np.float64)}
    for name, want in run["jax_grads"].items():
        _assert_grads(run["port_grads"][name], want, run["port_grads64"][name],
                      run["jax_grads64"][name], f"{regime} {name}")
    assert all(g is None for g in run["untouched"])  # GAN-Only: net_R


def _unweighted_d_phase(monkeypatch):
    d_phase = CSModel._d_phase_loss

    def fault(self, img_aligned, img_full_rss):
        total, lf, lr = d_phase(self, img_aligned, img_full_rss)
        return total / self.cfg.weight_gan, lf, lr

    monkeypatch.setattr(CSModel, "_d_phase_loss", fault)
    return {}


FAULTS = {  # a planted fault: (plant(monkeypatch) -> cfg overrides, the net it shows in)
    "d_phase_without_weight_gan": (_unweighted_d_phase, "net_D"),
    "g_phase_gan_sim_doubled": (lambda mp: {"weight_gan_sim": 2.0}, "net_G"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_step0_gradient_check_catches_a_planted_fault(run, monkeypatch, fault):
    """The step-0 check of the port against JAX fails on a port whose
    wiring scales a phase's loss wrong; the losses it reports are the
    unweighted terms, and Adam's step is scale-invariant."""
    regime, path = run["regime"], run["path"]
    plant, net = FAULTS[fault]
    cfg = _cfg(regime, **plant(monkeypatch))
    full, aux = _batch(0)
    got = _port_grads(path, cfg, full, aux, f64=False)[net]
    got64 = _port_grads(path, cfg, full, aux)[net]
    with pytest.raises(AssertionError):
        _assert_grads(got, run["jax_grads"][net], got64, run["jax_grads64"][net],
                      f"{regime} {fault}")


def test_three_updates_match_jax(run):
    tm, jstate = run["tm"], run["jax_state"]
    for step, (got, want) in enumerate(zip(run["port_losses"], run["jax_losses"])):
        _assert_losses(got, want, f"step {step}")
    noise = _noise_keys(tm)
    for name in GRAD_NETS[run["regime"]] + ("net_D",):
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jstate, "params", name),
                         STEPS, noise, f"{run['regime']} {name}")
    _assert_stats(tm, jstate, run["regime"])
    assert run["launches"] == {}  # CPU tensors take the plain versions


def test_port_checkpoint_with_opt_loads_in_jax(run):
    """The port's `save(with_opt=True)` after its updates: the JAX
    CSModel loads it (its `load` asserts that no optimizer key is missing
    or extra) and restores every net's params, stats and moments exactly."""
    from flax import serialization

    tm = run["tm"]
    saved = jckpt_load(run["port_ckpt"])
    jax_saved = jckpt_load(run["jax_ckpt"])
    assert set(saved["opt_state"]) == set(jax_saved["opt_state"])
    jm = JaxCSModel(ckpt=run["port_ckpt"])
    restored = flatten_tree(serialization.to_state_dict(jm.state["opt"]))
    for k, v in saved["opt_state"].items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v, err_msg=k)
    counts = {name: int(saved["opt_state"][f"{name}/0/count"]) for name in NETS}
    want = {name: STEPS for name in GRAD_NETS[run["regime"]] + ("net_D",)}
    assert counts == {name: want.get(name, 0) for name in NETS}
    for name in NETS:
        for key, v in {**_port_params(tm, name), **_port_stats(tm, name)}.items():
            coll, sub = key.split("/", 1)
            tree = jm.state["params" if coll == "params" else "stats"][name]
            np.testing.assert_array_equal(np.asarray(flatten_tree(tree)[sub]), v,
                                          err_msg=f"{name} {key}")


def test_jax_checkpoint_with_opt_resumes_in_port(run):
    """The JAX `save(with_opt=True)` after its updates: the port restores
    every net's moments and step exactly, and its next step matches the
    JAX next step (the Adam bar with n = 1, from equal states)."""
    regime = run["regime"]
    jm = run["jm"]
    jm.state = _copy(run["jax_state"])
    tm = CSModel(ckpt=run["jax_ckpt"], cfg=_cfg(regime), device="cpu")
    want = jckpt_load(run["jax_ckpt"])["opt_state"]
    ours = tm._opt_entries()
    for k, v in ours.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert set(want) == set(ours)  # net_mask's count too (a fixed mask has no weight)
    full, aux = _batch(9)
    tm.set_input(full, aux)
    tm.update()
    jm.set_input(full, aux)
    jm.update()
    _assert_losses(tm.get_vis("scalars")["scalars"], jm.get_vis("scalars")["scalars"],
                   f"resumed {regime}")
    for name in GRAD_NETS[regime] + ("net_D",):
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jm.state, "params", name),
                         1, _noise_keys(tm), f"resumed {regime} {name}")


@pytest.mark.parametrize("regime", ["Mixed", "GAN-Only"])
def test_gan_regime_at_batch_one_raises(regime):
    """forwardG halves the batch: batch 1 would push an empty half through
    net_G's BatchNorm (NaN in net_G, finite losses). Both packages refuse
    before anything moves; batch 2 with grad_accum 2 is batch 1 a
    micro-batch and is refused too."""
    full, aux = _batch(0, n=1)
    jm = JaxCSModel(cfg=JaxConfig(**_cfg(regime).to_dict()), seed=0)
    jm.set_input(full, aux)
    with pytest.raises(ValueError, match="forwardG crossover"):
        jm.update()
    tm = CSModel(cfg=_cfg(regime), device="cpu")
    before = [p.detach().clone() for p in tm.net_G.parameters()]
    tm.set_input(full, aux)
    with pytest.raises(ValueError, match="forwardG crossover"):
        tm.update()
    tm = CSModel(cfg=_cfg(regime, grad_accum=2), device="cpu")
    tm.set_input(*_batch(0, n=2))
    with pytest.raises(ValueError, match="forwardG crossover"):
        tm.update()
    assert all(torch.equal(a, p) for a, p in zip(before, tm.net_G.parameters()))
