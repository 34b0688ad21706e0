"""The PyTorch port's data parallelism (`parallel/mesh.py`,
`CSModel.distribute`) against the JAX package's step of one process on
the global batch, on the CPU.

One world of 2 ranks over gloo on the CPU, started with
`torch.multiprocessing.spawn` from `_rank` below and meeting in a FileStore
under tmp_path, runs every case in turn while this process takes the JAX
package's steps; each rank is fed its rows [r n / 2, (r + 1) n / 2) of the
global batch (`shard_batch`), as its loader would. The models are the tiny
ones of tests/test_torch_port_gan_train.py (16²), tests/test_torch_port_amp.py
(32², bf16) and tests/test_torch_port_mask_learning.py (32², LOUPE and
Taylor), each saved by the JAX package and loaded by both. Cases, each
against the JAX step on the whole batch at the bar of the file named:

  * Rec, 3 updates at global batch 4: the losses (rtol 1e-4), every
    parameter at the Adam bar (mean |diff| < 0.7 lr n, max < 2.5 lr n; the
    conv biases a BatchNorm follows the max alone) and net_T's running
    statistics (rtol 1e-4, means atol lr), tests/test_torch_port_train.py;
  * Mixed, 3 updates at batch 4: also net_G's and net_D's BatchNorm
    statistics and spectral-norm u, v (atol 1e-3), net_D stepped,
    tests/test_torch_port_gan_train.py. Each rank holds its own two rows,
    those of one half of forwardG's crossover: net_G runs on no rows on
    either rank in one of its two calls, and the BatchNorm statistics
    come from the other rank alone. net_G's running means after 3 updates
    are held at MIXED_G_MEAN_ATOL (below), not lr;
  * GAN-Only at grad_accum 2, 2 updates at batch 4 (one row a rank a
    micro-batch), tests/test_torch_port_gan_accum.py;
  * in each of these and the LOUPE case, the statistics after the first
    update, which the step takes from the starting weights (no Adam step
    has run yet), at rtol 1e-4 with atol 1e-6 (means, u and v);
  * one use_amp Mixed step at batch 2 (32²): the losses and every net's
    gradient at tests/test_torch_port_amp.py's bars (its gradient bar the
    larger of 5e-2 and 1.5 times JAX's own bf16 distance from f32);
  * the LOUPE-learned Rec step, 3 updates at batch 2 fed JAX's
    thresholds for the global batch: `pruned` after every update equal to
    JAX's on both ranks, the logits and nets at the Adam bar;
  * Taylor: 3 `taylor_step`s at batch 2, each saliency vector within 1e-4
    of its max of JAX's, then `prune(4)` equal;
  * `reconstruct` and `test` on a distributed model against the same
    model undistributed (rtol 1e-5); a batch of 3, which does not divide
    over 2 ranks, runs unsharded: `update` and `test` warn once,
    `reconstruct` says nothing, and every result is the solo one;
  * Mixed at global batch 24: `_remat_tg` on (net_T at 24, net_G's halves
    at 12, counted over the global batch, so each rank with its 12 rows
    rematerializes the same three calls) against off, rtol 1e-6, as
    tests/test_torch_port_remat.py.

Both ranks end every step with the same bits. Planted faults, which the
checks must catch: BatchNorm with each rank's own statistics (the Rec
case's check fails), and Taylor's gradient squared before the reduce (the
mean of each rank's squares in place of the square of the global
gradient: the Taylor check fails).

Inputs from numpy seeds.
"""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel

from spatialalignmentnetwork_tpu_torch.engine import csmodel as tcsmodel
from spatialalignmentnetwork_tpu_torch.engine import from_jax
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel
from spatialalignmentnetwork_tpu_torch.engine.eval import _bucket_pad
from spatialalignmentnetwork_tpu_torch.models import remat
from spatialalignmentnetwork_tpu_torch.parallel.mesh import make_mesh, shard_batch

from test_torch_port_amp import GRAD_JAX_FACTOR, GRAD_L2, LOSS_BAR, _net_l2, loss_dist
from test_torch_port_amp import _batch as amp_batch
from test_torch_port_amp import _jax_grads as amp_jax_grads
from test_torch_port_amp import make_start as amp_start
from test_torch_port_amp import slice_cfg
from test_torch_port_gan_train import SN_ATOL, _batch, _cfg, _copy, _jax_entry, _noise_keys
from test_torch_port_mask_learning import _batch as loupe_batch
from test_torch_port_mask_learning import _cfg as loupe_cfg
from test_torch_port_mask_learning import _draws, _small_head
from test_torch_port_train import _bn_biases

torch.set_num_threads(2)
LR = 1e-4
WORLD = 2
NETS = ("net_G", "net_D", "net_T", "net_R")
GAN_LOSSES = ("loss_gan_G", "loss_gan_Dfake", "loss_gan_Dreal")
STEPS = {"Rec": 3, "Mixed": 3, "GAN-Only": 2, "loupe": 3}
# the global batch of each case of tests/test_torch_port_gan_train.py's model
BATCH = {"Rec": 4, "Mixed": 4, "GAN-Only": 4}
# The bars of the statistics come from the port alone against JAX on 3
# Mixed updates of this file's model over 5 seeds at batches 2 and 4
# (`PYTHONPATH=. python3 tests/test_torch_port_parallel.py` prints them).
# After the first update, whose statistics come from the starting weights
# alone, a running mean needs at most 0.003 lr (3e-7) beside rtol 1e-4, a
# variance differs by at most 1.1e-6 of itself, u and v by 2.5e-7:
FIRST_RTOL, FIRST_ATOL = 1e-4, 1e-6
# after 3, net_G's running means carry the Adam noise of the weights and
# conv biases before them: they need 0.54-1.19 lr beside rtol 1e-4 (1.07 lr
# at this file's seed and batch 4, 0.95 lr at batch 2, which
# tests/test_torch_port_gan_train.py's atol lr holds); net_T's 0.48-0.54
# lr. net_G's bar is about twice its largest reading:
MIXED_G_MEAN_ATOL = 2.5 * LR
REMAT_BATCH = 24


def _gan_batches(case):
    return [_batch(step, n=BATCH[case]) for step in range(STEPS[case])]


def _loupe_batches():
    return [loupe_batch(step + 1) for step in range(STEPS["loupe"])]


def _taylor_batches():
    return [loupe_batch(10 + step, zero_plane=step == 0) for step in range(3)]


# ------------------------------------------------------------------ ranks
def _entries(tm):
    """The model's checkpoint entries, without its config."""
    ckpt = tm.checkpoint()
    ckpt.pop("config")
    return ckpt


def _grads(tm):
    """Every stepped net's gradient (`p.grad`: the group's mean) as JAX
    entries."""
    out = {}
    for name in NETS:
        params = dict(getattr(tm, name).named_parameters())
        if next(iter(params.values())).grad is not None:
            entries = [e for e in tm._entries(name) if e[1].startswith("params/")]
            out[name] = from_jax.to_jax_entries({k: p.grad for k, p in params.items()},
                                                entries)
    return out


def _updates(mesh, path, cfg, batches, draws=None, local_bn=False):
    """`update()`s of the model of checkpoint `path` distributed over
    `mesh`, each rank fed its rows: the losses, `pruned` after each step,
    the last step's gradients and the final entries. With `local_bn` (the
    planted fault) every BatchNorm keeps its rank's own statistics."""
    tm = CSModel(ckpt=path, cfg=cfg, device="cpu").distribute(mesh)
    if local_bn:
        tm._bns = []
    out = {"losses": [], "pruned": []}
    for step, (full, aux) in enumerate(batches):
        tm.set_input(shard_batch(mesh, full), shard_batch(mesh, aux))
        tm.update(None if draws is None else draws[step])
        out["losses"].append(tm.get_vis("scalars")["scalars"])
        out["pruned"].append(tm.pruned.numpy().copy())
        if step == 0:  # copies: the model's buffers advance in place
            out["first"] = {name: {k: np.array(v) for k, v in e.items()}
                            for name, e in _entries(tm).items() if isinstance(e, dict)}
    out["grads"], out["entries"] = _grads(tm), _entries(tm)
    return out


def _taylor(mesh, path):
    tm = CSModel(ckpt=path, device="cpu").distribute(mesh)
    for full, aux in _taylor_batches():
        tm.set_input(shard_batch(mesh, full), shard_batch(mesh, aux))
        tm.taylor_step()
    values = [v.numpy().copy() for v in tm._taylor_values]
    tm.prune(4)
    return {"values": values, "pruned": tm.pruned.numpy().copy(),
            "weight": tm.get_vis("histograms")["histograms"]["weights"]["values"]}


def _said(fn):
    """fn()'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _test_results(tm):
    return {k: v.numpy().copy() for k, v in tm._aux.items()}


def _serve(mesh, path):
    """reconstruct, test and an uneven update on a distributed model and on
    the same model alone."""
    cfg = _cfg("Mixed")
    solo = CSModel(ckpt=path, cfg=cfg, device="cpu")
    tm = CSModel(ckpt=path, cfg=cfg, device="cpu").distribute(mesh)
    out = {}
    full, aux = _batch(7, n=4)
    out["recon"] = [m.reconstruct(full, aux).numpy() for m in (tm, solo)]
    arrays, valid, _ = _bucket_pad(list(_batch(8, n=6)), 4)  # 6 slices padded to 8
    out["test"] = []
    for m in (tm, solo):
        m.eval()
        m.set_input(*arrays)
        m.test(valid)
        out["test"].append(_test_results(m))
    full3, aux3 = _batch(9, n=3)
    out["recon3"], out["recon3_said"] = _said(lambda: tm.reconstruct(full3, aux3).numpy())
    out["recon3_solo"] = solo.reconstruct(full3, aux3).numpy()
    tm.set_input(full3, aux3)
    _, out["test3_said"] = _said(tm.test)
    out["test3"] = _test_results(tm)
    solo.set_input(full3, aux3)
    solo.test()
    out["test3_solo"] = _test_results(solo)
    for m in (tm, solo):
        m.train()
    tm.set_input(shard_batch(mesh, full3), shard_batch(mesh, aux3))
    _, out["update3_said"] = _said(tm.update)
    _, out["update3_again"] = _said(tm.update)
    solo.set_input(full3, aux3)
    solo.update()
    solo.update()
    out["update3"] = [_entries(m) for m in (tm, solo)]
    return out


def _remat_tg(mesh, path):
    """One Mixed step at global batch REMAT_BATCH with `_remat_tg` on and
    off: the entries and the number of checkpointed calls."""
    full, aux = _batch(11, n=REMAT_BATCH)
    out = {}
    checkpoint, remat_tg = remat.checkpoint, tcsmodel._remat_tg
    for on in (True, False):
        calls = []

        def counted(fn, *args):
            calls.append(fn)
            return checkpoint(fn, *args)

        remat.checkpoint = counted
        if not on:
            tcsmodel._remat_tg = lambda batch, threshold=24: False
        try:
            tm = CSModel(ckpt=path, cfg=_cfg("Mixed"), device="cpu").distribute(mesh)
            tm.set_input(shard_batch(mesh, full), shard_batch(mesh, aux))
            tm.update()
        finally:
            remat.checkpoint, tcsmodel._remat_tg = checkpoint, remat_tg
        out[on] = (_entries(tm), len(calls))
    return out


def _rank(rank, tmp, paths, draws):
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu", init_method="file://" + os.path.join(tmp, "store"),
                     rank=rank, world_size=WORLD)
    try:
        out = {
            "Rec": _updates(mesh, paths["gan"], _cfg("Rec"), _gan_batches("Rec")),
            "Mixed": _updates(mesh, paths["gan"], _cfg("Mixed"), _gan_batches("Mixed")),
            "GAN-Only": _updates(mesh, paths["gan"], _cfg("GAN-Only", grad_accum=2),
                                 _gan_batches("GAN-Only")),
            "amp": _updates(mesh, paths["amp"], slice_cfg("Mixed"), [amp_batch(0)]),
            "loupe": _updates(mesh, paths["loupe"], loupe_cfg("Rec"), _loupe_batches(),
                              draws=draws),
            "taylor": _taylor(mesh, paths["taylor"]),
            "serve": _serve(mesh, paths["gan"]),
            "remat": _remat_tg(mesh, paths["gan"]),
            "local_bn": _updates(mesh, paths["gan"], _cfg("Rec"), _gan_batches("Rec"),
                                 local_bn=True),
        }
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- JAX side
def _head(jm, seed, bias):
    """A small non-zero STN head, so that the warp moves the reference."""
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(seed)
    head["kernel"] = jnp.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jnp.asarray(np.array(bias, np.float32))


def _jax_updates(jm, batches):
    losses, pruned = [], []
    for step, (full, aux) in enumerate(batches):
        jm.set_input(full, aux)
        jm.update()
        losses.append(jm.get_vis("scalars")["scalars"])
        pruned.append(np.asarray(jm.state["pruned"]))
        if step == 0:
            first = _copy(jm.state)
    return {"losses": losses, "pruned": pruned, "first": first, "state": _copy(jm.state)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results (rank 0's and rank 1's) and the JAX package's."""
    tmp = str(tmp_path_factory.mktemp("world"))
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("Mixed").to_dict()), seed=0)
    _head(jm, 6, [0.04, -0.03])
    state0 = _copy(jm.state)
    paths = {"gan": os.path.join(tmp, "gan")}
    jm.save(paths["gan"])
    os.makedirs(os.path.join(tmp, "amp"))
    jm_amp, jm_amp32, paths["amp"] = amp_start(os.path.join(tmp, "amp"))
    jl = JaxCSModel(cfg=JaxConfig(**loupe_cfg().to_dict()), seed=0)
    _small_head(jl)
    paths["loupe"] = os.path.join(tmp, "loupe")
    jl.save(paths["loupe"])
    jt = JaxCSModel(cfg=JaxConfig(**loupe_cfg("None", "taylor", False).to_dict()), seed=0)
    _small_head(jt)
    paths["taylor"] = os.path.join(tmp, "taylor")
    jt.save(paths["taylor"])
    # the thresholds of the JAX model's LOUPE updates, from its key
    # (PRNGKey(1) for seed 0), split once an update
    key, draws = jax.random.PRNGKey(1), []
    for _ in range(STEPS["loupe"]):
        draws.append(_draws(key)[0])
        key = jax.random.split(key)[0]

    ranks = torch.multiprocessing.spawn(_rank, args=(tmp, paths, draws), nprocs=WORLD,
                                        join=False)
    want = {}
    for regime in ("Rec", "Mixed"):
        jm.cfg.reg = regime
        jm.state = _copy(state0)
        want[regime] = _jax_updates(jm, _gan_batches(regime))
    ja = JaxCSModel(ckpt=paths["gan"], cfg=JaxConfig(**_cfg("GAN-Only", grad_accum=2).to_dict()))
    want["GAN-Only"] = _jax_updates(ja, _gan_batches("GAN-Only"))
    full, aux = amp_batch(0)
    want["amp"] = amp_jax_grads(jm_amp, "Mixed", full, aux)
    want["amp32"] = amp_jax_grads(jm_amp32, "Mixed", full, aux)[0]
    jl.cfg.reg = "Rec"
    jl._rng = jax.random.PRNGKey(1)
    want["loupe"] = _jax_updates(jl, _loupe_batches())
    for full, aux in _taylor_batches():
        jt.set_input(full, aux)
        jt.taylor_step()
    values = [np.asarray(v) for v in jt._taylor_values]
    jt.prune(4)
    want["taylor"] = {"values": values, "pruned": np.asarray(jt.state["pruned"]),
                      "weight": jt.get_vis("histograms")["histograms"]["weights"]["values"]}
    while not ranks.join():
        pass
    got = []
    for rank in range(WORLD):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    noise = {"gan": _noise_keys(CSModel(ckpt=paths["gan"], cfg=_cfg("Mixed"), device="cpu")),
             "loupe": _bn_biases(CSModel(ckpt=paths["loupe"], cfg=loupe_cfg(), device="cpu"))}
    return got, want, noise, paths


# ---------------------------------------------------------------- checks
def step_failures(got, want, nets, n, noise, stats_nets, mean_atol=None):
    """What of a distributed run `got` misses the bars against the JAX run
    `want` (module docstring): the losses of every update, the parameters
    of `nets` after n updates and the statistics of `stats_nets` after the
    first update and after n (a running mean at `mean_atol`'s atol for its
    net, else lr)."""
    fails = []
    for step, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        if set(g) != set(w):
            fails.append(f"step {step}: losses {sorted(g)} vs {sorted(w)}")
            continue
        for k, v in w.items():
            if abs(g[k] - v) > 1e-4 * abs(v) + (1e-6 if k in GAN_LOSSES else 0.0):
                fails.append(f"step {step} {k}: {g[k]} vs {v}")
    for name in nets:
        for key, w in _jax_entry(want["state"], "params", name).items():
            diff = np.abs(np.asarray(got["entries"][name][key], np.float64) - w)
            if diff.max() >= 2.5 * LR * n:
                fails.append(f"{name} {key}: max {diff.max():.3g}")
            if key not in noise and diff.mean() >= 0.7 * LR * n:
                fails.append(f"{name} {key}: mean {diff.mean():.3g}")
    for name in stats_nets:
        for key, w in _jax_entry(want["first"], "stats", name).items():
            g = np.asarray(got["first"][name][key])
            atol = FIRST_ATOL if key.endswith(("/u", "/v", "/mean")) else 0.0
            if not np.allclose(g, w, rtol=FIRST_RTOL, atol=atol):
                fails.append(f"{name} {key}: stats after 1 {np.abs(g - w).max():.3g}")
        mean = (mean_atol or {}).get(name, LR)
        for key, w in _jax_entry(want["state"], "stats", name).items():
            g = np.asarray(got["entries"][name][key])
            atol = (SN_ATOL if key.endswith(("/u", "/v")) else mean if key.endswith("/mean")
                    else 0.0)
            rtol = 0.0 if key.endswith(("/u", "/v")) else 1e-4
            if not np.allclose(g, w, rtol=rtol, atol=atol):
                fails.append(f"{name} {key}: stats {np.abs(g - w).max():.3g}")
    return fails


def assert_same_bits(a, b, what):
    """The two ranks' entries are the same bits."""
    assert a.keys() == b.keys(), what
    for name in a:
        for key in a[name]:
            assert np.array_equal(np.asarray(a[name][key]), np.asarray(b[name][key])), (
                f"{what}: {name} {key} differs between the ranks")


CASES = {  # case: (stepped nets, nets whose statistics are held, mean atols)
    "Rec": (("net_T", "net_R"), ("net_T",), None),
    "Mixed": (NETS, ("net_T", "net_G", "net_D"), {"net_G": MIXED_G_MEAN_ATOL}),
    "GAN-Only": (("net_T", "net_G", "net_D"), ("net_T", "net_G", "net_D"), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_world2_step_matches_jax_on_the_global_batch(world, case):
    got, want, noise, _ = world
    nets, stats, mean_atol = CASES[case]
    fails = step_failures(got[0][case], want[case], nets, STEPS[case], noise["gan"], stats,
                          mean_atol)
    assert not fails, fails
    assert_same_bits(got[0][case]["entries"], got[1][case]["entries"], case)
    assert got[0][case]["losses"] == got[1][case]["losses"]


def test_batchnorm_with_local_statistics_fails_the_check(world):
    """The planted fault: each rank normalises with its own rows'
    statistics (and keeps them as its running statistics)."""
    got, want, noise, _ = world
    nets, stats, _ = CASES["Rec"]
    fails = step_failures(got[0]["local_bn"], want["Rec"], nets, STEPS["Rec"], noise["gan"],
                          stats)
    assert any("stats" in f for f in fails), fails


def test_world2_bf16_mixed_step_matches_jax(world):
    got, want, _, _ = world
    (want_grads, want_losses), want32 = want["amp"], want["amp32"]
    got0 = got[0]["amp"]
    assert loss_dist(got0["losses"][0], want_losses) <= LOSS_BAR
    assert set(got0["grads"]) == set(want_grads)
    for name, w in want_grads.items():
        err, jax_err = _net_l2(got0["grads"][name], w), _net_l2(w, want32[name])
        bar = max(GRAD_L2, GRAD_JAX_FACTOR * jax_err)
        assert err <= bar, f"{name}: gradient {err:.3g} from JAX's bf16 > bar {bar:.3g}"
    for name in NETS:  # parameters and statistics stay f32
        assert {np.asarray(v).dtype for v in got0["entries"][name].values()} == {
            np.dtype(np.float32)}, name
    assert_same_bits(got0["entries"], got[1]["amp"]["entries"], "bf16 Mixed")


def test_world2_loupe_learned_rec_matches_jax(world):
    got, want, noise, _ = world
    fails = step_failures(got[0]["loupe"], want["loupe"], ("net_T", "net_R", "net_mask"),
                          STEPS["loupe"], noise["loupe"], ("net_T",))
    assert not fails, fails
    for step, w in enumerate(want["loupe"]["pruned"]):
        for rank in range(WORLD):
            np.testing.assert_array_equal(got[rank]["loupe"]["pruned"][step], w,
                                          err_msg=f"rank {rank} pruned after step {step}")
    assert_same_bits(got[0]["loupe"]["entries"], got[1]["loupe"]["entries"], "LOUPE")


def taylor_failures(values, want):
    return [f"batch {i}: {np.abs(v - w).max():.3g}" for i, (v, w) in enumerate(zip(values, want))
            if np.abs(v - w).max() > 1e-4 * np.abs(w).max()]


def test_world2_taylor_saliency_and_prune_match_jax(world):
    got, want, _, _ = world
    assert not taylor_failures(got[0]["taylor"]["values"], want["taylor"]["values"])
    for rank in range(WORLD):
        np.testing.assert_array_equal(got[rank]["taylor"]["pruned"], want["taylor"]["pruned"])
        w = want["taylor"]["weight"]
        np.testing.assert_allclose(got[rank]["taylor"]["weight"], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    for a, b in zip(got[0]["taylor"]["values"], got[1]["taylor"]["values"]):
        assert np.array_equal(a, b)


def test_taylor_squared_before_the_reduce_fails_the_check(world):
    """The planted fault: each rank squares its own rows' gradient and the
    squares are averaged, the mean of squares where JAX squares the global
    batch's gradient. Computed from the port's model alone on each rank's
    rows."""
    _, want, _, paths = world
    fault = []
    for full, aux in _taylor_batches():
        squares = []
        for rows in (slice(0, 1), slice(1, 2)):
            tm = CSModel(ckpt=paths["taylor"], device="cpu")
            tm.set_input(full[rows], aux[rows])
            tm.taylor_step()
            squares.append(tm._taylor_values[0].numpy())
        fault.append(np.mean(squares, axis=0))
    assert taylor_failures(fault, want["taylor"]["values"])


def _assert_close(got, want, what, rtol=1e-5):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def test_serving_and_eval_on_a_distributed_model(world):
    got, _, _, _ = world
    for rank in range(WORLD):
        out = got[rank]["serve"]
        np.testing.assert_allclose(out["recon"][0], out["recon"][1], rtol=1e-5, atol=1e-6)
        dp, solo = out["test"]
        assert dp.keys() == solo.keys()
        _assert_close(dp, solo, f"rank {rank} test (6 slices padded to 8)")
        # a batch of 3 over 2 ranks: unsharded, the solo results
        assert out["recon3_said"] == ""
        np.testing.assert_array_equal(out["recon3"], out["recon3_solo"])
        _assert_close(out["test3"], out["test3_solo"], f"rank {rank} test of 3", rtol=0)
        assert "batch 3 does not divide over the 2 ranks" in out["test3_said"]
        assert "update: batch 3 does not divide" in out["update3_said"]
        assert out["update3_again"] == ""  # once a batch size
        dp, solo = out["update3"]
        for name in NETS:
            _assert_close(dp[name], solo[name], f"rank {rank} uneven update {name}", rtol=1e-6)


def test_world2_remat_tg_at_global_batch_24_lands_on_the_same_state(world):
    got, _, _, _ = world
    for rank in range(WORLD):
        (on, calls_on), (off, calls_off) = got[rank]["remat"][True], got[rank]["remat"][False]
        assert calls_on == 3 and calls_off == 0  # net_T and net_G twice
        for name in NETS:
            for key, w in off[name].items():
                np.testing.assert_allclose(on[name][key], w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"rank {rank} {name} {key}")
    assert_same_bits(got[0]["remat"][True][0], got[1]["remat"][True][0], "remat on")


def _bar_readings(seeds=range(5), batches=(2, 4)):
    """The port alone against JAX on 3 Mixed updates of this file's model
    (seed s: the JAX model's seed, head seed 6 + s, batches 100 s + step),
    after the first update and after 3: for each net, the atol that its
    running means need beside rtol 1e-4 (in lr), and the largest relative
    difference of a variance; the largest difference of u or v."""
    import tempfile

    rows = []
    for n in batches:
        for seed in seeds:
            tmp = tempfile.mkdtemp()
            jm = JaxCSModel(cfg=JaxConfig(**_cfg("Mixed").to_dict()), seed=seed)
            _head(jm, 6 + seed, [0.04, -0.03])
            jm.save(os.path.join(tmp, "gan"))
            tm = CSModel(ckpt=os.path.join(tmp, "gan"), cfg=_cfg("Mixed"), device="cpu")
            for step in range(3):
                full, aux = _batch(100 * seed + step, n=n)
                for m in (jm, tm):
                    m.set_input(full, aux)
                    m.update()
                if step not in (0, 2):
                    continue
                worst, entries = {"u,v": 0.0}, _entries(tm)
                for name in ("net_T", "net_G", "net_D"):
                    for key, w in _jax_entry(_copy(jm.state), "stats", name).items():
                        w = np.asarray(w, np.float64)
                        d = np.abs(np.asarray(entries[name][key], np.float64) - w)
                        if key.endswith("/mean"):
                            kind, value = f"{name} mean", (d - 1e-4 * np.abs(w)).max() / LR
                        elif key.endswith("/var"):
                            kind, value = f"{name} var", (d / np.abs(w)).max()
                        else:
                            kind, value = "u,v", d.max()
                        worst[kind] = max(worst.get(kind, -np.inf), value)
                rows.append((n, seed, step + 1, worst))
    return rows


if __name__ == "__main__":
    for n, seed, after, worst in _bar_readings():
        print(f"batch {n} seed {seed} after {after}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
