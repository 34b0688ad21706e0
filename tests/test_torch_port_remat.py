"""Rematerialization in the port (`models/remat.py`: cfg.net_R_remat
around each cascade, and `_remat_tg`'s net_T and net_G training forwards
from a batch of 24 and a half batch of 12) against the same steps without
it and against the JAX package's own step, on the CPU, in f32.

Remat changes no value: after one update with it on, every parameter,
BatchNorm running statistic and spectral-norm vector equals the update's
with it off to rtol 1e-6 (tests/test_engine.py:559's bar for the JAX
package's own lever). The recomputation must not update state a second
time: a planted fault that lets it (BatchNorm taking a second momentum
update, the power iteration advancing again) fails that check. With remat
on, the port's Rec and Mixed steps land on the JAX package's (whose net_R
remat is on by default, and whose `_remat_tg` is on at batch 24) at the
bars of tests/test_torch_port_gan_train.py. The tiny configuration of
that file (16², 2 cascades, 4 channels); inputs from numpy seeds. Last,
`chip_smoke.py`'s phase 14 on the CPU at a small shape.
"""

import os
import sys

import numpy as np
import pytest
import jax
import torch

from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel

from spatialalignmentnetwork_tpu_torch.engine import csmodel as tcsmodel
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
from spatialalignmentnetwork_tpu_torch.models import remat

from test_torch_port_gan_train import (_assert_adam_bar, _assert_stats, _batch, _cfg,
                                       _copy, _jax_entry, _noise_keys, _port_params)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("net_G", "net_D", "net_T", "net_R")
BIG = 24  # `_remat_tg`'s threshold: net_T at 24, net_G on its half batch of 12


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A saved tiny JAX model (its STN head non-zero, so that the warp moves
    the reference) and a copy of its state."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("Mixed").to_dict()), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(6)
    head["kernel"] = jax.numpy.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jax.numpy.asarray(np.array([0.04, -0.03], np.float32))
    path = str(tmp_path_factory.mktemp("remat") / "start")
    jm.save(path)
    return jm, _copy(jm.state), path


def _state(tm) -> dict:
    """Every parameter and buffer of the four nets (BatchNorm statistics,
    u and v), as numpy."""
    return {f"{name}.{k}": v.detach().numpy().copy()
            for name in NETS for k, v in getattr(tm, name).state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _step(path, regime, n, net_r_remat, monkeypatch, remat_tg=True):
    """The port's state after one update of `regime` at batch `n`, and how
    many checkpointed calls and replayed values the step made."""
    counts = {"checkpoint": 0, "replay": 0}
    checkpoint, replay = remat.checkpoint, remat.replay

    def counted_checkpoint(fn, *args):
        counts["checkpoint"] += 1
        return checkpoint(fn, *args)

    def counted_replay():
        counts["replay"] += 1
        return replay()

    with monkeypatch.context() as m:
        m.setattr(remat, "checkpoint", counted_checkpoint)
        m.setattr(remat, "replay", counted_replay)
        if not remat_tg:
            m.setattr(tcsmodel, "_remat_tg", lambda batch, threshold=24: False)
        tm = CSModel(ckpt=path, cfg=_cfg(regime, net_R_remat=net_r_remat), device="cpu")
        tm.set_input(*_batch(0, n=n))
        tm.update()
    return tm, counts


def _assert_same(got, want, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=f"{what} {k}")


@pytest.mark.parametrize("regime", ["Rec", "Mixed"])
def test_net_r_remat_lands_on_the_same_state(start, regime, monkeypatch):
    _, _, path = start
    off, counts_off = _step(path, regime, 2, False, monkeypatch)
    on, counts_on = _step(path, regime, 2, True, monkeypatch)
    assert counts_off["checkpoint"] == 0
    assert counts_on["checkpoint"] == 2  # one a cascade
    _assert_same(_state(on), _state(off), f"{regime} net_R_remat")


def test_remat_tg_at_batch_24_lands_on_the_same_state(start, monkeypatch):
    """Mixed at batch 24: net_T's forward and both of net_G's (half batches
    of 12) rematerialized, against the same step with `_remat_tg` off; the
    recomputations replay the spectral-norm vectors of the forward."""
    _, _, path = start
    off, counts_off = _step(path, "Mixed", BIG, False, monkeypatch, remat_tg=False)
    on, counts_on = _step(path, "Mixed", BIG, False, monkeypatch)
    assert counts_off == {"checkpoint": 0, "replay": 0}
    assert counts_on["checkpoint"] == 3  # net_T, net_G twice
    snconvs_g = len([m for m in on.net_G.modules() if isinstance(m, tcsmodel.SpectralConv)])
    assert counts_on["replay"] == 2 * snconvs_g
    _assert_same(_state(on), _state(off), "remat_tg")
    assert not tcsmodel._remat_tg(BIG - 1) and tcsmodel._remat_tg(BIG)
    assert not tcsmodel._remat_tg(11, 12) and tcsmodel._remat_tg(12, 12)


def test_a_recomputation_that_updates_state_fails(start, monkeypatch):
    """The planted fault: the recomputation is not told that it is one, so
    BatchNorm updates its running statistics again and the power iteration
    advances again. The check of the test above must fail."""
    _, _, path = start
    off, _ = _step(path, "Mixed", BIG, False, monkeypatch, remat_tg=False)
    monkeypatch.setattr(remat, "recomputing", lambda: False)
    on, _ = _step(path, "Mixed", BIG, False, monkeypatch)
    with pytest.raises(AssertionError):
        _assert_same(_state(on), _state(off), "fault")


def test_recomputation_on_another_thread_replays(monkeypatch):
    """The backward, and so the recomputation, may run on another thread
    than the forward (on a card, autograd's device thread): a BatchNorm
    and spectral-norm conv checkpointed in one thread and differentiated in
    another replays the forward's (u, v), updates no buffer a second time,
    and gives the gradients of the same block without remat."""
    import copy
    import threading

    from spatialalignmentnetwork_tpu_torch.models.gan import SNConv

    torch.manual_seed(0)
    block = SNConv(3, 4, generator=torch.Generator().manual_seed(1)).train()
    twin = copy.deepcopy(block)
    x = torch.randn(2, 3, 8, 8)
    block(x).square().sum().backward()
    replays = []
    replay = remat.replay
    monkeypatch.setattr(remat, "replay", lambda: replays.append(1) or replay())
    loss = remat.checkpoint(twin, x).square().sum()
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    assert replays == [1]
    for (k, got), want in zip(twin.state_dict().items(), block.state_dict().values()):
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=k)
    for (k, got), want in zip(twin.named_parameters(), block.parameters()):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("regime,n", [("Rec", 2), ("Mixed", BIG)])
def test_remat_step_matches_jax(start, regime, n, monkeypatch):
    """The port with net_R_remat (and at batch 24 `_remat_tg`) against the
    JAX package's step, its defaults rematerializing the same nets: the
    parameters at the Adam bar, net_G's BatchNorm statistics and u, v and
    net_T's statistics at the bars of tests/test_torch_port_gan_train.py."""
    jm, state0, path = start
    jm.cfg.reg = regime
    jm.state = _copy(state0)
    jm.set_input(*_batch(0, n=n))
    jm.update()
    tm, counts = _step(path, regime, n, True, monkeypatch)
    assert counts["checkpoint"] == 2 + (3 if n >= BIG else 0)
    np.testing.assert_allclose(tm.get_vis("scalars")["scalars"]["loss_all"],
                               float(jm.get_vis("scalars")["scalars"]["loss_all"]), rtol=1e-4)
    for name in NETS:
        _assert_adam_bar(_port_params(tm, name), _jax_entry(jm.state, "params", name), 1,
                         _noise_keys(tm) if name in ("net_T", "net_G") else (), f"{regime}")
    _assert_stats(tm, jm.state, regime, names=("net_G", "net_T"))


def test_chip_smoke_precision_phase_runs_on_cpu():
    """chip_smoke.py's phase 14 (bf16 serving, the bf16 steps, the f32 Rec
    step with net_R_remat off and on, the bf16 Mixed step at batch 24 with
    `_remat_tg` on and off, the bf16 Mixed step at its big batch with
    remat off and on, the bf16 None, GAN-Only and LOUPE steps, a bf16 eval
    volume, each with its dtype check of the nets) at 32x32, this file's
    widths and small batches, on the CPU: its logic is exercised here, its
    numbers only on a card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    widths = {k: v for k, v in _cfg("Mixed").to_dict().items() if k.startswith("net_")}
    launches = chip_smoke.check_precision(np.random.default_rng(0), device="cpu", shape=32,
                                          serve_batch=2, batch=2, big=4, widths=widths)
    assert launches == {}  # CPU tensors take the plain versions
