"""The PyTorch port's gradient accumulation (`grad_accum=2`) against the JAX
package's accumulation step, in Rec, Mixed and GAN-Only, on the CPU.

The tiny JAX CSModel of tests/test_torch_port_gan_train.py is saved and
loaded by the port. At batch 4 with grad_accum 2 (micro-batches of 2; in
the GAN regimes slice i of each TR/RT half):

  * the averaged step-0 gradients of every stepped net (net_D's from the
    D-phase), read from a copy of the JAX model whose optimizers are plain
    SGD at rate 1 (its step is then params - gradients, through the JAX
    package's own accumulation code), at the bar of the plain step
    (tests/test_torch_port_gan_train.py: 1e-3 of the leaf's max + 1e-6 of
    the net's; the port against JAX with both in float64, the JAX copy's
    nets at flax dtype float64 under x64, and in f32 within the bar plus
    JAX's own distance from its float64);
  * 2 Adam updates against 2 JAX updates: the micro-batch mean losses
    (rtol 1e-4, the adversarial ones also atol 1e-6), the parameters at
    the Adam bar, net_T's and net_G's BatchNorm statistics threaded
    through the micro-batches (rtol 1e-4, atol lr) and net_G's and
    net_D's spectral-norm vectors, restarted from the step's own at each
    micro-batch (atol 1e-3).

Inputs from numpy seeds.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.engine.csmodel import GRAD_NETS

from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

from test_torch_port_gan_train import (
    _assert_adam_bar, _assert_grads, _assert_losses, _assert_stats, _batch, _cfg, _copy,
    _jax_entry, _jax_f64, _noise_keys, _port_entry, _port_grads, _port_params,
)

torch.set_num_threads(2)
ACCUM = 2
BATCH = 4
STEPS = 2


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("Mixed", grad_accum=ACCUM).to_dict()), seed=1)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(7)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jnp.asarray(np.array([-0.02, 0.05], np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "start")
    jm.save(path)
    return jm, _copy(jm.state), path


def _stepped(regime):
    return GRAD_NETS[regime] + (("net_D",) if regime != "Rec" else ())


def _jax_sgd_grads(jm, state0, regime, full, aux):
    """The JAX accumulation step's averaged gradients: one step of SGD at
    rate 1 from state0 (params - new params). Leaves jm at state0 with its
    own optimizers. The batch goes in as given (set_input would round a
    complex128 batch to complex64)."""
    tx = jm.tx
    jm.tx = {k: optax.sgd(1.0) for k in tx}
    jm.state = _copy(state0)
    jm.state["opt"] = {k: jm.tx[k].init(jm.state["params"][k]) for k in jm.tx}
    jm._step_cache = {}
    jm._batch = (jnp.asarray(full), jnp.asarray(aux))
    jm.update()
    out = {}
    for name in _stepped(regime):
        before = _jax_entry(state0, "params", name)
        after = _jax_entry(jm.state, "params", name)
        out[name] = {k: before[k] - after[k] for k in before}
    jm.tx = tx
    jm._step_cache = {}
    jm.state = _copy(state0)
    return out


@pytest.fixture(scope="module", params=["Rec", "Mixed", "GAN-Only"])
def run(request, start):
    regime = request.param
    jm, state0, path = start
    jm.cfg.reg = regime
    full0, aux0 = _batch(0, n=BATCH)
    out = {"regime": regime, "jax_losses": [], "port_losses": []}
    out["jax_grads"] = _jax_sgd_grads(jm, state0, regime, full0, aux0)
    with jax.enable_x64(True):
        jm64 = _jax_f64(path, _cfg(regime, grad_accum=ACCUM))
        out["jax_grads64"] = _jax_sgd_grads(jm64, _copy(jm64.state), regime,
                                            full0.astype(np.complex128),
                                            aux0.astype(np.complex128))
    out["port_grads64"] = _port_grads(path, _cfg(regime, grad_accum=ACCUM), full0, aux0)
    tm = CSModel(ckpt=path, cfg=_cfg(regime, grad_accum=ACCUM), device="cpu")
    for step in range(STEPS):
        full, aux = _batch(step, n=BATCH)
        tm.set_input(full, aux)
        tm.update()
        if step == 0:
            out["port_grads"] = {
                name: _port_entry(tm, name, {k: p.grad for k, p in
                                             getattr(tm, name).named_parameters()})
                for name in _stepped(regime)}
        out["port_losses"].append(tm.get_vis("scalars")["scalars"])
        jm.set_input(full, aux)
        jm.update()
        out["jax_losses"].append(jm.get_vis("scalars")["scalars"])
    out["tm"], out["jax_state"] = tm, _copy(jm.state)
    return out


def test_accumulated_step0_gradients_match_jax(run):
    assert set(run["port_grads64"]) == set(run["jax_grads"]) == set(run["jax_grads64"])
    assert {v.dtype for g in run["jax_grads64"].values() for v in g.values()} == {
        np.dtype(np.float64)}
    for name, want in run["jax_grads"].items():
        _assert_grads(run["port_grads"][name], want, run["port_grads64"][name],
                      run["jax_grads64"][name], f"{run['regime']} {name}")


def test_accumulated_updates_match_jax(run):
    tm, jstate, regime = run["tm"], run["jax_state"], run["regime"]
    for step, (got, want) in enumerate(zip(run["port_losses"], run["jax_losses"])):
        _assert_losses(got, want, f"{regime} step {step}")
    noise = _noise_keys(tm)
    for name in _stepped(regime):
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jstate, "params", name),
                         STEPS, noise, f"{regime} {name}")
    _assert_stats(tm, jstate, regime, ("net_T", "net_G", "net_D"))
