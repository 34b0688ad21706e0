"""The PyTorch port's mask learning against the JAX package, on the CPU, at
the train CLI's `--net_scale tiny` widths (2 cascades) on a 32x32 plane,
LOUPE at sparsity 0.25 (8 of 32 lines kept), batch 2.

A tiny JAX CSModel with a LOUPE mask (its STN head small but non-zero, as
in tests/test_torch_port_train.py) is saved once; the port loads the
checkpoint, so both start from the same weights, logits and `pruned`.
The port takes the thresholds the JAX step draws (`uniform(sub, (N, W))`
and `uniform(fold_in(sub, 1), (1, W))`, `sub` split from the model's key)
through `update(draws)`. Then:

  * learned-mask steps, Rec over 3 updates and None and Mixed over 1:
    step 0's losses (rtol 1e-5) and gradients of every net the step steps
    against `jax.grad` of the JAX `_prepare` and `_regime_loss`, net_mask's
    logits included (1e-3 of the leaf's max + 1e-6 of the net's; net_G's
    and net_D's in Mixed are held in tests/test_torch_port_gan_train.py,
    where flax's one-pass BatchNorm variances need float64); the losses of
    every update (rtol 1e-4), `pruned` equal after every update, and every
    stepped parameter, the logits included, to the Adam bar of
    tests/test_train_step_parity.py (mean |diff| < 0.7 lr n, max < 2.5 lr
    n; net_T's BatchNorm-followed biases the max alone), net_T's running
    statistics rtol 1e-4 (means atol lr). Step 0's batch holds a zero
    plane, where |img_sampled| is 0 exactly and the gradient reaches
    net_T through it.
  * LOUPE without learn_mask: the logits and `pruned` stay as they were.
  * Taylor: three `taylor_step`s and `prune(4)` against the JAX model's:
    each saliency vector at rtol 1e-4 of its max, the pruned set equal,
    the histograms' weight equal; no BatchNorm statistic moves.
  * magnitude pruning through the model over two jittered rounds, and a
    fixed mask's prune at the default threshold (a no-op), as JAX's.
  * checkpoints both ways: LOUPE's logits with their Adam moments and
    count, and a Taylor mask's saliency with `get_vis("histograms")`.
  * the two train CLIs, 3 steps of `--mask loupe --learn_mask --aux_aug
    None` from one JAX checkpoint (the port fed the JAX CLI's draws):
    every leaf to the Adam bar with n = 3, `pruned` equal; one port
    `--prune_every` run through `main`; the flags' ValueErrors; and
    `chip_smoke.py`'s phase 13 on the CPU at a small size.

Inputs come from numpy seeds.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.engine import train as jtrain
from spatialalignmentnetwork_tpu.engine.checkpoint import ckpt_load as jckpt_load
from spatialalignmentnetwork_tpu.engine.checkpoint import flatten_tree
from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.engine.csmodel import GRAD_NETS
from spatialalignmentnetwork_tpu.ops import masks as jmasks

from spatialalignmentnetwork_tpu_torch.engine import from_jax
from spatialalignmentnetwork_tpu_torch.engine import train as ttrain
from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

from conftest import write_h5_volume
from test_torch_port_gan_train import _jax_f64
from test_torch_port_train import _assert_adam_bar, _bn_biases, _copy, _jax_entry, _port_params
from test_torch_port_train_cli import _route_writers

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
SHAPE = 32
N = 2
KEPT = int(0.25 * SHAPE + 0.5)


def _argv(logdir, csv, reg="Rec", mask="loupe", extra=()):
    """The toy run's flags: the protocol's weights, tiny widths, no
    augmentation, 3 steps of 2 from 6 slices."""
    return ["--logdir", str(logdir), "--train", csv, "--val", csv, "--reg", reg,
            "--protocals", "T2", "T1", "--mask", mask, "--sparsity", "0.25",
            "--smooth_weight", "1000", "--gan_weight", "0.1", "--gan_sim_weight", "1",
            "--sim_weight", "1", "--aux_aug", "None", "--batch_size", str(N),
            "--crop", str(SHAPE), "--epoch", "1", "--intel_stop", "1", "--num_workers", "2",
            "--net_scale", "tiny", "--seed", "0", *extra]


def _cfg(reg="Rec", mask="loupe", learn_mask=True):
    cfg = ttrain.build_cfg(ttrain.build_parser().parse_args(_argv("-", "-", "Rec", mask)))
    cfg.reg = reg
    cfg.learn_mask = learn_mask
    return cfg


def _batch(seed, zero_plane=False):
    rng = np.random.default_rng(300 + seed)
    mk = lambda: (rng.random((N, 1, SHAPE, SHAPE))
                  + 1j * rng.random((N, 1, SHAPE, SHAPE))).astype(np.complex64)
    full, aux = mk(), mk()
    if zero_plane:
        full[1] = 0
    return full, aux


def _draws(key):
    """The thresholds a JAX update of the model whose key is `key` draws."""
    _, sub = jax.random.split(key)
    return (np.array(jax.random.uniform(sub, (N, SHAPE))),
            np.array(jax.random.uniform(jax.random.fold_in(sub, 1), (1, SHAPE)))), sub


def _small_head(jm):
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jnp.asarray(rng.standard_normal(head["kernel"].shape).astype(np.float32)
                                 * 0.05)
    head["bias"] = jnp.asarray(np.array([0.05, -0.03], np.float32))


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A saved tiny JAX LOUPE model and a copy of its state."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg().to_dict()), seed=0)
    _small_head(jm)
    path = str(tmp_path_factory.mktemp("loupe") / "start")
    jm.save(path)
    return jm, _copy(jm.state), path


def _jax_step0(jm, regime, full, aux, names, sub, thresh=None):
    """jax.grad of the JAX package's learned-mask loss (`_prepare` with the
    soft sample, then `_regime_loss`) for the nets `names`: the soft
    sample of key `sub` (the JAX step's own draw), or with `thresh` in
    place of the key's draw (the same draw cast up, for the float64 step:
    JAX draws other values in float64)."""
    params = jm.state["params"]

    def fixed(weight, sparsity, pmask_slope, sample_slope, key, batch, training):
        pmask = jmasks.loupe_pmask(weight, sparsity, pmask_slope)
        score = pmask[None, :] - jnp.asarray(thresh, pmask.dtype)
        return jax.nn.sigmoid(score * sample_slope), None

    def loss_fn(train_params):
        p = {**params, **train_params}
        env = jm._prepare(jnp.asarray(full), jnp.asarray(aux), jm.state["pruned"],
                          p["net_mask"], sub)
        total, losses, _, _ = jm._regime_loss(p, jm.state["stats"], env, regime)
        return total, losses

    with pytest.MonkeyPatch.context() as mp:
        if thresh is not None:
            mp.setattr(jmasks, "loupe_sample", fixed)
        grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(
            {k: params[k] for k in names})
    return ({name: {f"params/{k}": np.asarray(v) for k, v in flatten_tree(grads[name]).items()}
             for name in names}, {k: float(v) for k, v in losses.items()})


def _port_step0_f64(path, regime, full, aux, draws, names):
    """The port's learned-mask step-0 gradients in float64 (the warp's
    plain version reads its grid in f32)."""
    tm = CSModel(ckpt=path, cfg=_cfg(regime), device="cpu")
    for name in ("net_T", "net_R", "net_G", "net_D", "net_mask"):
        getattr(tm, name).to(torch.float64)
    tm._batch = (torch.from_numpy(full).to(torch.complex128),
                 torch.from_numpy(aux).to(torch.complex128))
    tm.update(draws)
    return {name: _port_params(tm, name, {k: p.grad for k, p in
                                          getattr(tm, name).named_parameters()})
            for name in names}


@pytest.fixture(scope="module")
def zero_plane(start):
    """A learned Rec step's step-0 gradients on a batch with a zero plane,
    in both packages, in f32 and float64."""
    jm, state0, path = start
    jm.cfg.reg = "Rec"
    jm.state = _copy(state0)
    names = GRAD_NETS["Rec"] + ("net_mask",)
    full, aux = _batch(0, zero_plane=True)
    draws, sub = _draws(jax.random.PRNGKey(1))
    out = {"names": names}
    out["jax_grads"], out["jax_loss0"] = _jax_step0(jm, "Rec", full, aux, names, sub)
    with jax.enable_x64(True):
        out["jax_grads64"], _ = _jax_step0(
            _jax_f64(path, _cfg()), "Rec", full.astype(np.complex128),
            aux.astype(np.complex128), names, sub, thresh=draws[0].astype(np.float64))
    out["port_grads64"] = _port_step0_f64(path, "Rec", full, aux, draws, names)
    tm = CSModel(ckpt=path, cfg=_cfg(), device="cpu")
    tm.set_input(full, aux)
    tm.update(draws)
    out["port_loss0"] = tm.get_vis("scalars")["scalars"]
    out["port_grads"] = {name: _port_params(tm, name, {
        k: p.grad for k, p in getattr(tm, name).named_parameters()}) for name in names}
    return out


def test_learned_mask_step0_gradients_match_jax_through_a_zero_plane(zero_plane):
    """Step 0 of a learned Rec step on a batch whose second target is 0:
    |img_sampled| is 0 there exactly, and its gradient, like every other,
    as JAX's. The losses at rtol 1e-5; each leaf's gradient, the logits'
    included, at the bar of the module docstring in float64, and in f32
    within that bar plus JAX's own f32 distance from its float64 (a zero
    plane leaves net_R's normalisations dividing by their eps, where f32
    determines the gradient in neither package)."""
    for k, v in zero_plane["jax_loss0"].items():
        np.testing.assert_allclose(zero_plane["port_loss0"][k], v, rtol=1e-5, err_msg=k)
    assert "net_mask" in zero_plane["names"]
    for name in zero_plane["names"]:
        got, want = zero_plane["port_grads"][name], zero_plane["jax_grads"][name]
        got64, want64 = zero_plane["port_grads64"][name], zero_plane["jax_grads64"][name]
        assert got.keys() == want.keys() == got64.keys() == want64.keys(), name
        assert {v.dtype for v in want64.values()} == {np.dtype(np.float64)}
        net_max = max(float(np.abs(w).max()) for w in want64.values())
        assert net_max > 0, name
        for key, ref in want64.items():
            bar = 1e-3 * float(np.abs(ref).max()) + 1e-6 * net_max
            e64 = float(np.abs(got64[key] - ref).max())
            e_port = float(np.abs(got[key] - got64[key]).max())
            e_jax = float(np.abs(want[key] - ref).max())
            assert e64 <= bar and e_port <= bar + e_jax, (
                f"{name} {key}: port-jax f64 {e64:.3g}, port f32-f64 {e_port:.3g}, "
                f"jax f32-f64 {e_jax:.3g}, bar {bar:.3g}")


# the nets whose updates are held here; a Mixed step's net_G and net_D,
# whose f32 gradients flax's one-pass BatchNorm variances put over the
# bar, are held in float64 in tests/test_torch_port_gan_train.py
HELD = {"Rec": ("net_T", "net_R", "net_mask"), "None": ("net_R", "net_mask"),
        "Mixed": ("net_T", "net_R", "net_mask")}
GAN_LOSSES = ("loss_gan_G", "loss_gan_Dfake", "loss_gan_Dreal")


@pytest.fixture(scope="module", params=[("Rec", 3), ("None", 1), ("Mixed", 1)],
                ids=["Rec", "None", "Mixed"])
def learned(request, start):
    """The learned-mask updates of one regime, in both packages."""
    regime, steps = request.param
    jm, state0, path = start
    jm.cfg.reg = regime
    jm.state = _copy(state0)
    jm._rng = jax.random.PRNGKey(1)  # a fresh model's key (seed 0)
    tm = CSModel(ckpt=path, cfg=_cfg(regime), device="cpu")
    out = {"regime": regime, "steps": steps, "tm": tm,
           "jax_losses": [], "port_losses": [], "jax_pruned": [], "port_pruned": []}
    w0 = tm.net_mask.weight.detach().clone()
    for step in range(steps):
        full, aux = _batch(step + 1)
        draws, _ = _draws(jm._rng)
        tm.set_input(full, aux)
        tm.update(draws)
        out["port_losses"].append(tm.get_vis("scalars")["scalars"])
        out["port_pruned"].append(tm.pruned.numpy().copy())
        jm.set_input(full, aux)
        jm.update()
        out["jax_losses"].append(jm.get_vis("scalars")["scalars"])
        out["jax_pruned"].append(np.asarray(jm.state["pruned"]))
    out["logits_moved"] = float((tm.net_mask.weight.detach() - w0).abs().max())
    out["jax_state"] = _copy(jm.state)
    return out


def test_learned_mask_updates_match_jax(learned):
    """Every update's losses (rtol 1e-4; the adversarial ones also atol
    1e-6), `pruned` after every update, and the stepped nets' parameters,
    the logits included, to the Adam bar; net_T's statistics."""
    tm, jstate, n = learned["tm"], learned["jax_state"], learned["steps"]
    for step, (got, want) in enumerate(zip(learned["port_losses"], learned["jax_losses"])):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                       atol=1e-6 if k in GAN_LOSSES else 0.0,
                                       err_msg=f"step {step} {k}")
    for step, (got, want) in enumerate(zip(learned["port_pruned"], learned["jax_pruned"])):
        np.testing.assert_array_equal(got, want, err_msg=f"pruned after step {step}")
        assert int((~got).sum()) == KEPT
    assert learned["logits_moved"] > 0
    noise = _bn_biases(tm)
    for name in HELD[learned["regime"]]:
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jstate, "params", name), n,
                         noise, f"{learned['regime']} {name}")
    sd = tm.net_T.state_dict()
    want = _jax_entry(jstate, "stats", "net_T")
    for tkey, jkey, _, _ in from_jax.stn_entries(tm.net_T):
        if jkey.startswith("stats/"):
            np.testing.assert_allclose(sd[tkey].numpy(), want[jkey], rtol=1e-4,
                                       atol=LR if jkey.endswith("/mean") else 0.0,
                                       err_msg=jkey)


def test_loupe_without_learn_mask_keeps_its_logits(start):
    """The reference's live path: a LOUPE mask trains nothing of its own
    without learn_mask; its logits, their Adam state and `pruned` stay."""
    _, _, path = start
    tm = CSModel(ckpt=path, cfg=_cfg(learn_mask=False), device="cpu")
    w0, pruned0 = tm.net_mask.weight.detach().clone(), tm.pruned.clone()
    for step in range(2):
        tm.set_input(*_batch(step))
        tm.update()
    assert torch.equal(tm.net_mask.weight.detach(), w0)
    assert torch.equal(tm.pruned, pruned0)
    assert not tm.opt["net_mask"].state
    with pytest.raises(ValueError, match="learns no mask"):
        tm.update(_draws(jax.random.PRNGKey(1))[0])


def test_learn_mask_with_grad_accum_is_refused(start):
    _, _, path = start
    cfg = _cfg()
    cfg.grad_accum = 2
    tm = CSModel(ckpt=path, cfg=cfg, device="cpu")
    tm.set_input(*_batch(0))
    with pytest.raises(ValueError, match="grad_accum does not route gradients"):
        tm.update()


@pytest.fixture(scope="module")
def taylor(tmp_path_factory):
    """A saved tiny JAX Taylor model."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("None", "taylor", False).to_dict()), seed=0)
    _small_head(jm)
    path = str(tmp_path_factory.mktemp("taylor") / "start")
    jm.save(path)
    return jm, _copy(jm.state), path


def _reset_taylor(jm, state0):
    jm.state = _copy(state0)
    jm._taylor_values = []
    jm.__dict__.pop("_taylor_saliency", None)


def test_taylor_saliency_and_prune_match_jax(taylor):
    jm, state0, path = taylor
    _reset_taylor(jm, state0)
    tm = CSModel(ckpt=path, device="cpu")
    stats = {k: v.clone() for k, v in tm.net_T.state_dict().items()}
    for step in range(3):
        batch = _batch(10 + step, zero_plane=step == 0)
        tm.set_input(*batch)
        tm.taylor_step()
        jm.set_input(*batch)
        jm.taylor_step()
    for got, want in zip(tm._taylor_values, jm._taylor_values):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    assert all(torch.equal(v, stats[k]) for k, v in tm.net_T.state_dict().items())
    tm.prune(4)
    jm.prune(4)
    np.testing.assert_array_equal(tm.pruned.numpy(), np.asarray(jm.state["pruned"]))
    assert int(tm.pruned.sum()) == 4 and tm._taylor_values == []
    got = tm.get_vis("histograms")["histograms"]["weights"]["values"]
    want = jm.get_vis("histograms")["histograms"]["weights"]["values"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="taylor_step first"):
        tm.prune(2)  # no saliency since the last prune


def test_magnitude_prune_through_the_model_matches_jax():
    """A plain `mask` with small weights on some lines: two jittered rounds
    of prune(3) from the model's generator, as the JAX model's; a fixed
    mask (all-ones weight) prunes nothing at the default threshold."""
    cfg = _cfg(mask="mask", learn_mask=False)
    tm = CSModel(cfg=cfg, device="cpu")
    jm = JaxCSModel(cfg=JaxConfig(**cfg.to_dict()), seed=0)
    w = np.ones(SHAPE, np.float32)
    w[[1, 5, 9, 12, 20, 27, 30]] = np.random.default_rng(6).uniform(0.01, 0.6, 7)
    tm.net_mask.set_weight(w)
    jm.state["params"]["net_mask"]["weight"] = jnp.asarray(w)
    for _ in range(2):
        tm.prune(3, random=0.5)
        jm.prune(3, random=0.5)
        np.testing.assert_array_equal(tm.pruned.numpy(), np.asarray(jm.state["pruned"]))
    assert int(tm.pruned.sum()) == 6
    fixed = CSModel(cfg=_cfg(mask="equispaced", learn_mask=False), device="cpu")
    before = fixed.pruned.clone()
    fixed.prune(2)
    assert torch.equal(fixed.pruned, before)
    loupe = CSModel(cfg=_cfg(), device="cpu")
    before = loupe.pruned.clone()
    loupe.prune(2)  # LOUPE prunes through its logits
    assert torch.equal(loupe.pruned, before)


def test_loupe_checkpoint_with_adam_moments_both_ways(start, tmp_path):
    """JAX `save(with_opt=True)` after a learned step: the port restores
    net_mask's logits, moments and count exactly and writes them back the
    same; a port `save(with_opt=True)` after its own step loads in the JAX
    CSModel, which restores every optimizer key exactly."""
    from flax import serialization

    jm, state0, _ = start
    jm.cfg.reg = "Rec"
    jm.state = _copy(state0)
    jm.set_input(*_batch(1))
    jm.update()
    path = str(tmp_path / "jax")
    jm.save(path, with_opt=True)
    tm = CSModel(ckpt=path, cfg=_cfg(), device="cpu")
    want = jckpt_load(path)
    np.testing.assert_array_equal(tm.net_mask.weight.detach().numpy(),
                                  want["net_mask"]["params/weight"])
    st = tm.opt["net_mask"].state[tm.net_mask.weight]
    opt = want["opt_state"]
    assert int(st["step"]) == int(opt["net_mask/0/count"]) == 1
    np.testing.assert_array_equal(st["exp_avg"].numpy(), opt["net_mask/0/mu/weight"])
    np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), opt["net_mask/0/nu/weight"])
    back = str(tmp_path / "back")
    tm.save(back, with_opt=True)
    got = jckpt_load(back)
    for k in [k for k in opt if k.startswith("net_mask/")]:
        np.testing.assert_array_equal(got["opt_state"][k], opt[k], err_msg=k)
    np.testing.assert_array_equal(got["net_mask"]["pruned"], want["net_mask"]["pruned"])

    tm.set_input(*_batch(2))
    tm.update()
    out = str(tmp_path / "port")
    tm.save(out, with_opt=True)
    saved = jckpt_load(out)
    assert int(saved["opt_state"]["net_mask/0/count"]) == 2
    jm2 = JaxCSModel(ckpt=out)
    restored = flatten_tree(serialization.to_state_dict(jm2.state["opt"]))
    assert set(restored) == set(saved["opt_state"])
    for k, v in saved["opt_state"].items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v, err_msg=k)
    np.testing.assert_array_equal(np.asarray(jm2.state["params"]["net_mask"]["weight"]),
                                  tm.net_mask.weight.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jm2.state["pruned"]), tm.pruned.numpy())


def test_taylor_checkpoint_carries_the_saliency_both_ways(taylor, tmp_path):
    """A pruned Taylor mask's saliency is net_mask's `weight` in its
    checkpoint: the JAX one loads in the port (the slot created, read by
    `get_vis("histograms")`), the port's (with its optimizer keys) loads in
    the JAX CSModel, each histogram the other's."""
    jm, state0, path = taylor
    _reset_taylor(jm, state0)
    for step in range(2):
        jm.set_input(*_batch(20 + step))
        jm.taylor_step()
    jm.prune(3)
    jpath = str(tmp_path / "jax")
    jm.save(jpath)
    tm = CSModel(ckpt=jpath, device="cpu")
    want = jm.get_vis("histograms")["histograms"]["weights"]["values"]
    np.testing.assert_array_equal(tm.get_vis("histograms")["histograms"]["weights"]["values"],
                                  want)
    np.testing.assert_array_equal(tm.pruned.numpy(), np.asarray(jm.state["pruned"]))

    fresh = CSModel(ckpt=path, device="cpu")
    assert fresh.net_mask.weight is None and fresh.get_vis("histograms")["histograms"] == {}
    for step in range(2):
        fresh.set_input(*_batch(30 + step))
        fresh.taylor_step()
    fresh.prune(3)
    out = str(tmp_path / "port")
    fresh.save(out, with_opt=True)
    jm2 = JaxCSModel(ckpt=out)
    np.testing.assert_array_equal(jm2.get_vis("histograms")["histograms"]["weights"]["values"],
                                  fresh.net_mask.weight.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jm2.state["pruned"]), fresh.pruned.numpy())
    assert int(fresh.pruned.sum()) == 3


# ------------------------------------------------------------------ the CLIs
@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Two T1/T2 pairs of 3 slices at 40² (train crops 35, val 32): 3
    steps of 2."""
    root = tmp_path_factory.mktemp("mask_cli")
    rows = []
    for v in range(2):
        for proto, seed in (("T1", v * 2), ("T2", v * 2 + 1)):
            write_h5_volume(str(root / f"p{v}_{proto}.h5"), proto, shape=(3, 40, 40),
                            seed=seed)
        rows.append(f"p{v}_T1.h5,p{v}_T2.h5")
    csv = root / "pairs.csv"
    csv.write_text("\n".join(rows) + "\n")
    return root, str(csv)


def test_loupe_train_clis_agree(start, workspace, tmp_path):
    """Both CLIs `--resume` one JAX LOUPE checkpoint and train 3 steps with
    `--learn_mask --aux_aug None --save_opt`, the port from the thresholds
    the JAX model's key gives (its `update` fed them): net_T's, net_R's and
    the logits' leaves to the Adam bar with n = 3, net_G and net_D
    untouched, `pruned` and Adam's counts equal."""
    _, csv = workspace
    _, _, path = start
    extra = ["--learn_mask", "--save_opt", "--resume", path]
    jargs = jtrain.build_parser().parse_args(_argv(tmp_path / "jax", csv, extra=extra))
    targs = ttrain.build_parser().parse_args(_argv(tmp_path / "port", csv, extra=extra)
                                             + ["--device", "cpu"])
    update = CSModel.update
    key = {"rng": jax.random.PRNGKey(1)}  # the CLI's model: seed 0

    def fed(self, draws=None):
        draws, _ = _draws(key["rng"])
        key["rng"] = jax.random.split(key["rng"])[0]
        return update(self, draws)

    with pytest.MonkeyPatch.context() as mp:
        from spatialalignmentnetwork_tpu.utils import cache

        mp.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
        _route_writers(mp)
        jtrain.main(jargs)
        mp.setattr(CSModel, "update", fed)
        rec = ttrain.main(targs)
    assert rec["iter_cnt"] == 3 and rec["prunes"] == []
    final = os.path.join("ckpt", "ckpt_%010d.pt" % 3)
    got, want = ckpt_load(str(tmp_path / "port" / final)), jckpt_load(
        str(tmp_path / "jax" / final))
    tm = CSModel(ckpt=str(tmp_path / "port" / final), device="cpu")
    for name in ("net_T", "net_R", "net_mask"):
        keys = [k for k in want[name] if k.startswith("params/")]
        _assert_adam_bar({k: got[name][k] for k in keys}, {k: want[name][k] for k in keys},
                         3, _bn_biases(tm), f"CLI {name}")
    np.testing.assert_array_equal(got["net_mask"]["pruned"], want["net_mask"]["pruned"])
    assert int((~got["net_mask"]["pruned"]).sum()) == KEPT
    start_ckpt = jckpt_load(path)
    for name in ("net_G", "net_D"):
        for k, v in start_ckpt[name].items():
            np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name} {k}")
    for k in ("net_T/0/count", "net_R/0/count", "net_mask/0/count", "net_G/0/count"):
        assert int(got["opt_state"][k]) == int(want["opt_state"][k]), k


def test_prune_every_run_through_main(workspace, tmp_path, capsys):
    """`--mask taylor --prune_every 2 --prune_num 3 --reg None`: the
    saliency of every step, one prune at iteration 2 with its keep density
    printed; the final checkpoint carries the 3 pruned lines and the
    saliency as net_mask's weight."""
    _, csv = workspace
    args = ttrain.build_parser().parse_args(
        _argv(tmp_path, csv, reg="None", mask="taylor",
              extra=["--prune_every", "2", "--prune_num", "3", "--device", "cpu"]))
    with pytest.MonkeyPatch.context() as mp:
        _route_writers(mp)
        rec = ttrain.main(args)
    assert rec["prunes"] == [(2, 1.0 - 3 / SHAPE)]
    assert "pruned at iter 2: keep density 0.9062" in capsys.readouterr().out
    saved = ckpt_load(str(tmp_path / "ckpt" / ("ckpt_%010d.pt" % 3)))
    assert int(saved["net_mask"]["pruned"].sum()) == 3
    assert saved["net_mask"]["params/weight"].shape == (SHAPE,)


@pytest.mark.parametrize("flags,match", [
    (["--learn_mask", "--mask", "equispaced"], "--learn_mask needs --mask loupe"),
    (["--learn_mask", "--reg", "GAN-Only"], "--learn_mask is inert under --reg GAN-Only"),
    (["--prune_every", "2", "--mask", "taylor"], "--prune_every needs --prune_num"),
    (["--prune_every", "2", "--prune_num", "2"], "--prune_every: LOUPE prunes"),
], ids=["learn_mask-not-loupe", "learn_mask-gan-only", "prune_every-no-num",
        "prune_every-loupe"])
def test_mask_flags_that_cannot_act_raise(workspace, tmp_path, flags, match):
    """The JAX CLI's asserts, as ValueErrors naming the flag, before
    anything is built or written."""
    _, csv = workspace
    args = ttrain.build_parser().parse_args(_argv(tmp_path, csv) + flags
                                            + ["--device", "cpu"])
    with pytest.raises(ValueError, match=match):
        ttrain.main(args)
    assert not os.path.exists(tmp_path / "ckpt")


def test_chip_smoke_mask_phase_runs_on_cpu(tmp_path):
    """chip_smoke.py's phase 13 on the CPU at 32x32 (full widths; the CLI
    runs at tiny widths on volumes of 4 slices): its logic is exercised
    here, its numbers only on a card. The planted fault fails inside it."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    launches = chip_smoke.check_masks(np.random.default_rng(0), device="cpu", shape=32,
                                      batch=2, net_scale="tiny", slices=4,
                                      workdir=str(tmp_path / "cli"), prune_num=4)
    assert launches == {}  # CPU tensors take the plain versions
    assert not os.path.exists(tmp_path / "cli")
    assert chip_smoke.STEP_LAUNCHES["Rec"] == chip_smoke.TAYLOR_LAUNCHES == {
        "grid_sample_fwd": 1, "grid_sample_bwd_dgrid": 1, "ssim_fwd": 1, "ssim_bwd": 1}
