"""The PyTorch port's CSModel at two coils against the JAX package, on the
CPU.

One tiny JAX CSModel at `coils=2` (the tests/test_torch_port_train.py
config, reg "Rec", a non-zero STN head so the warp moves the reference by
sub-pixel amounts) is saved once for the module; the port loads it, so
both start from the same weights, BatchNorm statistics and mask. The
reference image has two coils too, as in tests/test_multicoil.py. Then:

  * `reconstruct` against the JAX `reconstruct` on the same numpy inputs,
    at the coils=1 serving bar (rtol 1e-3, atol 1e-4,
    tests/test_torch_port_serve.py);
  * three Rec `update()`s against three JAX `update()`s: loss_all,
    loss_sim and loss_smooth at each step to rtol 1e-4, the coils=1 bar
    of tests/test_torch_port_train.py.

Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

torch.set_num_threads(2)
COILS = 2
SERVE_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_RTOL = 1e-4
STEPS = 3


def _cfg():
    """tests/test_torch_port_train.py::_cfg("Rec") at two coils."""
    return Config(
        sparsity=0.25, lr=1e-4, shape=16, coils=COILS, reg="Rec",
        mask="equispaced", weight_smooth=1000.0, weight_gan=0.1,
        weight_gan_sim=1.0, weight_sim=1.0, net_G_layers=(4, 8),
        net_D_blocks=((4,), (8,)), net_T_layers=(4, 8), net_R_cascades=2,
        net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
        net_R_sens_pools=1,
    )


def _batch(seed, n=2, shape=16):
    rng = np.random.default_rng(200 + seed)
    mk = lambda: (rng.random((n, COILS, shape, shape))
                  + 1j * rng.random((n, COILS, shape, shape))).astype(np.complex64)
    return mk(), mk()


def _copy(state):
    # a JAX update donates its state: keep an independent copy
    return jax.tree_util.tree_map(jnp.array, state)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """The saved two-coil JAX model, and a copy of its state."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg().to_dict()), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05
    )
    head["bias"] = jnp.asarray(np.array([0.05, -0.03], np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "coils2")
    jm.save(path)
    return jm, _copy(jm.state), path


def test_reconstruct_matches_jax_at_two_coils(start):
    jm, state0, path = start
    jm.state = _copy(state0)
    tm = CSModel(ckpt=path, device="cpu")
    for seed in (0, 1):
        full, aux = _batch(seed)
        want = np.asarray(jm.reconstruct(full, aux))
        got = tm.reconstruct(full, aux)
        assert got.shape == (2, 1, 16, 16) and want.shape == got.shape
        np.testing.assert_allclose(got.numpy(), want, **SERVE_TOL)


def test_three_rec_updates_match_jax_at_two_coils(start):
    jm, state0, path = start
    jm.state = _copy(state0)
    tm = CSModel(ckpt=path, cfg=_cfg(), device="cpu")
    kernels.reset_launches()
    for step in range(STEPS):
        full, aux = _batch(10 + step)
        tm.set_input(full, aux)
        tm.update()
        got = tm.get_vis("scalars")["scalars"]
        jm.set_input(full, aux)
        jm.update()
        want = jm.get_vis("scalars")["scalars"]
        assert set(got) == set(want) == {"loss_all", "loss_sim", "loss_smooth"}
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=f"step {step} {k}")
    assert dict(kernels.LAUNCHES) == {}  # CPU tensors take the plain versions
