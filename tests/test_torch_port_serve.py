"""The PyTorch port's serving slice against the JAX package, on the CPU.

A tiny JAX CSModel (the tests/test_engine.py config, reg "Rec") is saved
with `CSModel.save`; the port loads that checkpoint directory and its
`reconstruct` must match the JAX `reconstruct` on the same numpy inputs
(rtol 1e-3, atol 1e-4, the bar of tests/test_torch_parity.py). Also: the
port imports neither JAX nor the JAX package, and its entry points do not
fall back to the CPU when no card is there.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel
from spatialalignmentnetwork_tpu.ops import masks as jmasks

from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(shape=16):
    """tests/test_engine.py::tiny_cfg with reg "Rec"."""
    return Config(
        sparsity=0.25, lr=1e-4, shape=shape, coils=1, reg="Rec",
        mask="equispaced", weight_smooth=1000.0, weight_gan=0.1,
        weight_gan_sim=1.0, weight_sim=1.0, net_G_layers=(4, 8),
        net_D_blocks=((4,), (8,)), net_T_layers=(4, 8), net_R_cascades=1,
        net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
        net_R_sens_pools=1,
    )


def _batch(shape=16, n=2, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.random((n, 1, shape, shape))
                  + 1j * rng.random((n, 1, shape, shape))).astype(np.complex64)
    return mk(), mk()


@pytest.fixture(scope="module")
def saved_jax_model(tmp_path_factory):
    """A saved tiny JAX model whose STN head is non-zero (zero-init in
    training), so the warp moves the reference by sub-pixel amounts."""
    jm = JaxCSModel(cfg=JaxConfig(**tiny_cfg().to_dict()), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05
    )
    head["bias"] = jnp.asarray(np.array([0.05, -0.03], np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    jm.save(path)
    return jm, path


def test_reconstruct_matches_jax(saved_jax_model):
    jm, path = saved_jax_model
    tm = CSModel(ckpt=path, device="cpu")
    assert tm.num_low_frequencies == jm.num_low_frequencies
    np.testing.assert_array_equal(
        tm.pruned.numpy(), np.asarray(jm.state["pruned"])
    )
    for seed in (0, 1):
        full, aux = _batch(seed=seed)
        want = np.asarray(jm.reconstruct(full, aux))
        got = tm.reconstruct(full, aux)
        assert got.shape == (2, 1, 16, 16) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # no reference modality: zeros, as in the JAX serving path
    full, _ = _batch(seed=2)
    np.testing.assert_allclose(
        tm.reconstruct(full).numpy(), np.asarray(jm.reconstruct(full)), **TOL
    )


def test_checkpoint_mask_is_used_as_saved(saved_jax_model, tmp_path):
    """A LOUPE checkpoint cannot regenerate its mask here (its first sample
    is JAX's random bits): the port serves the saved `pruned`."""
    jm, path = saved_jax_model
    copy = tmp_path / "loupe"
    shutil.copytree(path, copy)
    cfg = Config().load(str(copy / "config"))
    cfg.mask = "loupe"
    cfg.save(str(copy / "config"))
    tm = CSModel(ckpt=str(copy), device="cpu")
    np.testing.assert_array_equal(
        tm.pruned.numpy(), np.asarray(jm.state["pruned"])
    )
    full, aux = _batch(seed=5)
    np.testing.assert_allclose(
        tm.reconstruct(full, aux).numpy(),
        np.asarray(jm.reconstruct(full, aux)), **TOL,
    )


def test_fresh_build_matches_jax_mask_and_identity_warp():
    cfg = tiny_cfg()
    tm = CSModel(cfg=cfg, device="cpu", seed=3)
    want = jmasks.make_mask(cfg.mask, cfg.shape, cfg.sparsity, seed=3).pruned
    np.testing.assert_array_equal(tm.pruned.numpy(), want)
    # zero-init STN head: the grid is the identity
    full, aux = _batch(seed=4)
    with torch.no_grad():
        offset, _ = tm.net_T(torch.from_numpy(np.abs(aux)),
                             torch.from_numpy(np.abs(full)))
    assert float(offset.abs().max()) == 0.0
    assert torch.isfinite(tm.reconstruct(full, aux)).all()


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's examples."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import spatialalignmentnetwork_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, examples.torch_quickstart, examples.torch_serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'spatialalignmentnetwork_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CSModel(cfg=tiny_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CSModel(cfg=tiny_cfg(), device="cuda:0")


def test_chip_smoke_serving_phase_runs_on_cpu():
    """chip_smoke.py's serving phase (weights in the JAX layout through
    from_jax, phantoms, the card-vs-CPU check) at full widths but 32x32,
    on the CPU: its logic is exercised here, its numbers only on a card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    launches = chip_smoke.check_serving(
        np.random.default_rng(0), device="cpu", shape=32, batch=2
    )
    assert launches == {}  # CPU tensors take the plain version

