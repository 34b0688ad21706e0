"""The PyTorch port's CLIs with `--data_parallel`, on the CPU, against the
JAX package's CLIs run alone, at the toy size of
tests/test_torch_port_train_cli.py (2 h5 volume pairs of 4 slices at 24²,
crop 16, `--net_scale tiny`).

Each world of 2 ranks over gloo is started with
`torch.multiprocessing.spawn` from `_cli_rank` below, meeting in a
FileStore under tmp_path; each rank runs the port's `main` in the world it
joined, as it would under torchrun. TensorBoard is stubbed in the ranks.

  * The train CLI, `--reg Rec --aux_aug None --batch_size 4 --seed 0
    --save_opt`, both from one JAX checkpoint whose STN head is small but
    non-zero (tests/test_torch_port_train_cli.py): the port's world of 2
    (each rank loading its shard, `Loader(2, num_shards=2, shard_index=r)`,
    whose global batch is the solo loader's) against the JAX CLI alone,
    every leaf of the final checkpoint at that file's bars with n = 2
    steps (the Adam bar, BatchNorm statistics, Adam's counts and moments);
    rank 0 alone writes the checkpoints; both ranks log the same
    validation scalars, the JAX CLI's metric_PSNR within 1e-3 dB.
  * The eval CLI, `--data_parallel --bucket 3` (each volume padded to 6
    slices, 3 a rank, the halves of forwardG's crossover cut unevenly),
    on the port's trained checkpoint against the JAX eval CLI: per-volume
    metrics at the eval bars of tests/test_torch_port_eval.py (PSNR within
    1e-3 dB); rank 0 alone writes the metrics file and `--save`.
  * The JAX CLI's multi-host asserts, as ValueErrors before anything
    starts: `--dist_*` without `--seed`, a global batch that does not
    divide over the world, `--dist_*` without `--data_parallel`.
  * `chip_smoke.py`'s phase 15 on the CPU at 32², tiny widths: its logic
    here, its numbers only on a card. TensorBoard is made unimportable
    for it (its import pulls in TensorFlow here, about 15 s a process).
  * `parallel/` imports no JAX.

Inputs from numpy seeds.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import torch
import torch.distributed as dist

from spatialalignmentnetwork_tpu.engine import eval as jeval
from spatialalignmentnetwork_tpu.engine import train as jtrain
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel

from spatialalignmentnetwork_tpu_torch.engine import eval as teval
from spatialalignmentnetwork_tpu_torch.engine import train as ttrain
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

from test_torch_port_eval import _assert_scalars
from test_torch_port_train import _bn_biases
from test_torch_port_train_cli import (
    PSNR_ATOL, _Writer, _argv, _route_writers, _val_scalars, checkpoint_failures)
from test_torch_port_train_cli import workspace  # noqa: F401 (the toy h5 workspace fixture)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
BATCH = 4
STEPS = 2  # 8 train slices at the global batch of 4
BUCKET = 3
DP_FLAGS = ["--aux_aug", "None", "--batch_size", str(BATCH), "--save_opt"]


def _cli_rank(rank, tmp, which, argv):
    """One rank: join the world of `tmp`'s FileStore, then the port's
    `which` CLI on `argv`; its return value to <which><rank>.pkl."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = types.SimpleNamespace(SummaryWriter=_Writer)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, f"{which}.store"),
                            rank=rank, world_size=WORLD)
    try:
        cli = ttrain if which == "train" else teval
        out = cli.main(cli.build_parser().parse_args(argv))
        with open(os.path.join(tmp, f"{which}{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _world(tmp, which, argv):
    """The port's `which` CLI in a world of WORLD ranks; each rank's return
    value."""
    torch.multiprocessing.spawn(_cli_rank, args=(str(tmp), which, argv), nprocs=WORLD)
    out = []
    for rank in range(WORLD):
        with open(os.path.join(tmp, f"{which}{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(workspace, tmp_path_factory):
    """The JAX train CLI alone and the port's in a world of 2, Rec, one
    epoch from one JAX checkpoint: (root, the JAX CLI's logged scalars,
    the ranks' run records, the checkpoint)."""
    _, csv = workspace
    root = tmp_path_factory.mktemp("dp_runs")
    start = str(root / "start.pt")
    jargs = jtrain.build_parser().parse_args(
        _argv(root / "jax", csv, extra=DP_FLAGS + ["--resume", start]))
    jm = JaxCSModel(cfg=jtrain.build_cfg(jargs), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jax.numpy.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jax.numpy.asarray(np.array([0.05, -0.03], np.float32))
    jm.save(start, with_opt=True)
    with pytest.MonkeyPatch.context() as mp:
        from spatialalignmentnetwork_tpu.utils import cache

        mp.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
        made = _route_writers(mp)
        jtrain.main(jargs)
    ranks = _world(root, "train", _argv(root / "port", csv, extra=DP_FLAGS + [
        "--resume", start, "--data_parallel", "--device", "cpu"]))
    return root, made[0].scalars, ranks, start


def test_train_cli_world2_matches_the_jax_cli_alone(runs):
    root, jax_scalars, ranks, start = runs
    final = "ckpt_%010d.pt" % STEPS
    for who in ("jax", "port"):
        assert sorted(os.listdir(root / who / "ckpt")) == ["best.pt", final], who
    noise = _bn_biases(CSModel(ckpt=start, device="cpu"))
    fails = checkpoint_failures(str(root / "port" / "ckpt" / final),
                                str(root / "jax" / "ckpt" / final), noise, n=STEPS)
    assert not fails, fails
    assert [r["iter_cnt"] for r in ranks] == [STEPS, STEPS]
    # every rank scores the global val batches: the same validation
    got = [_val_scalars(r["scalars"]) for r in ranks]
    assert got[0] == got[1] and got[0]
    want = _val_scalars(jax_scalars)
    assert abs(got[0]["metric_PSNR"] - want["metric_PSNR"]) <= PSNR_ATOL, (got[0], want)


def test_eval_cli_world2_matches_the_jax_eval_cli(runs, workspace, tmp_path, monkeypatch):
    root, _, _, _ = runs
    _, csv = workspace
    ckpt = str(root / "port" / "ckpt" / ("ckpt_%010d.pt" % STEPS))
    from spatialalignmentnetwork_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    want_json = str(tmp_path / "jax.json")
    jeval.main(argparse.Namespace(
        resume=ckpt, val=csv, crop=16, protocals=["T2", "T1"], aux_aug=-1.0, bucket=BUCKET,
        data_parallel=False, save=None, metric=want_json))
    got_json, save = str(tmp_path / "port.json"), str(tmp_path / "port_out")
    ranks = _world(tmp_path, "eval", [
        "--resume", ckpt, "--val", csv, "--protocals", "T2", "T1", "--bucket", str(BUCKET),
        "--device", "cpu", "--data_parallel", "--metric", got_json, "--save", save])
    with open(want_json) as f:
        want = json.load(f)["volumes"]
    with open(got_json) as f:
        got = json.load(f)
    assert got["meta"]["ranks"] == WORLD and len(got["volumes"]) == len(want) == 2
    for i, (g, w) in enumerate(zip(got["volumes"], want)):
        _assert_scalars(g, w, f"volume {i}")
    assert ranks[0] == ranks[1]  # every rank's mean scalars
    assert len(os.listdir(save)) == 12  # 2 volumes x 6 files, from rank 0


@pytest.mark.parametrize("flags,match", [
    (["--data_parallel", "--dist_coordinator", "localhost:1", "--dist_num_processes", "2",
      "--dist_process_id", "0"], "needs --seed"),
    (["--data_parallel", "--dist_coordinator", "localhost:1", "--dist_num_processes", "3",
      "--dist_process_id", "0", "--seed", "0"], "does not divide over 3 ranks"),
    (["--dist_coordinator", "localhost:1", "--dist_num_processes", "2",
      "--dist_process_id", "0", "--seed", "0"], "need --data_parallel"),
], ids=["no seed", "indivisible batch", "no data_parallel"])
def test_the_jax_clis_multihost_asserts_are_value_errors(workspace, tmp_path, flags, match):
    """Raised before any process starts or any rendezvous is tried."""
    _, csv = workspace
    argv = _argv(tmp_path, csv)
    del argv[argv.index("--seed"):argv.index("--seed") + 2]
    args = ttrain.build_parser().parse_args(argv + ["--device", "cpu"] + flags)
    with pytest.raises(ValueError, match=match):
        ttrain.main(args)
    assert not os.path.exists(tmp_path / "ckpt")


def test_chip_smoke_parallel_phase_runs_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 15 (the train CLI's spawn path alone and
    data-parallel, the gloo world's Rec and Mixed steps and eval against
    one process) on the CPU at 32x32, tiny widths, batch 2, volumes of 4
    slices (eval of 6 and 4): its logic is exercised here, its numbers
    only on a card."""
    (tmp_path / "no_tb" / "tensorboard").mkdir(parents=True)
    (tmp_path / "no_tb" / "tensorboard" / "__init__.py").write_text(
        "raise ImportError('TensorBoard is left out of this test')\n")
    monkeypatch.syspath_prepend(str(tmp_path / "no_tb"))
    monkeypatch.delitem(sys.modules, "torch.utils.tensorboard", raising=False)
    monkeypatch.syspath_prepend(REPO)  # the spawned ranks import chip_smoke too
    import chip_smoke

    launches = chip_smoke.check_parallel(np.random.default_rng(0), device="cpu", shape=32,
                                         batch=2, net_scale="tiny", slices=4,
                                         workdir=str(tmp_path / "p15"), eval_slices=(6, 4))
    assert launches == {}  # CPU tensors take the plain versions
    assert not os.path.exists(tmp_path / "p15")


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import spatialalignmentnetwork_tpu_torch.parallel.mesh\n"
            "import spatialalignmentnetwork_tpu_torch.engine.csmodel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'spatialalignmentnetwork_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
