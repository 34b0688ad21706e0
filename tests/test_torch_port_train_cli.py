"""The PyTorch port's train CLI (`engine/train.py`) against the JAX
package's, on the CPU, at the toy size of tests/test_e2e.py: 2 h5 volume
pairs of 4 slices at 24², crop 16 (train slices cropped to 17 for
augmentation), `--net_scale tiny`, batch 2.

  * Parity, `--reg Rec --aux_aug PBSpline --seed 0`: both CLIs `--resume`
    one JAX-written checkpoint (`save(with_opt=True)` of a fresh tiny JAX
    model whose zero STN head is replaced by small random weights, as in
    tests/test_torch_port_train.py: at the exact identity grid every
    sample sits on the bilinear kink, where the two frameworks' warp
    gradients are different subgradients), train one epoch (4 updates)
    with `--intel_stop 1 --save_opt`.
    The JAX CLI runs once, in a module fixture. Both shuffle with numpy
    from the seed; the port takes the PBSpline draws JAX makes from the
    keys the JAX CLI splits (`PRNGKey(seed)`, one split a step), through
    `train.draw_augmentation`. Bars: every parameter leaf to the Adam bar
    of tests/test_train_step_parity.py with n = 4, as
    tests/test_torch_port_train.py applies it (mean |diff| < 0.7 lr n,
    max < 2.5 lr n; the net_T conv biases that a BatchNorm follows, whose
    exact gradient is 0, the max alone); BatchNorm statistics rtol 1e-4,
    means atol lr; Adam's counts exactly; its moments within
    MOMENT_RTOL of each leaf's largest |value| plus MOMENT_FLOOR of the
    net's largest (mu and nu sum the gradients, and their squares, of
    steps taken at weights that differ within the Adam bar: the largest
    differences read 1.4e-2 of a leaf's max and 1.9e-3 of a net's; the
    floor also covers the BatchNorm-followed biases, whose moments are
    rounding noise); the nets a Rec step does not touch bit for bit; the
    epoch's validation scalars against the JAX CLI's validation loop on
    the same weights at the eval bars of tests/test_torch_port_eval.py. A
    control: the port's CLI on another batch order (`--seed 1`) misses
    these bars.
  * The reference's four-stage protocol (commands_train_test.sh:48-65)
    through the port's `main`, with `--load_nets` and `--resume ""`:
    every stage writes best.pt and its final checkpoint, each warm-started
    net equals its checkpoint bit for bit before the first step, `--resume
    ""` continues the iteration count from the checkpoint's name, every
    logged loss is finite; then the port's eval CLI on the last best.pt.
  * The CLI's cadences (monkeypatched to every iteration): scalars,
    histograms, image grids, periodic checkpoints, `--trace_at`.
  * `--use_amp` (the bf16 policy) in both CLIs, their losses update by
    update at the bf16 step bar.
  * Refusals: `--load_nets` without `--resume`, `--device cuda` without
    a card (the data-parallel flags' ValueErrors:
    tests/test_torch_port_parallel_cli.py).
  * `chip_smoke.py`'s train-CLI phase on the CPU at a small shape.

Inputs come from numpy seeds.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import torch

from spatialalignmentnetwork_tpu.engine import train as jtrain
from spatialalignmentnetwork_tpu.engine.checkpoint import ckpt_load as jckpt_load
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel

from spatialalignmentnetwork_tpu_torch import kernels
from spatialalignmentnetwork_tpu_torch.engine import eval as teval
from spatialalignmentnetwork_tpu_torch.engine import train as ttrain
from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load
from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

from conftest import write_h5_volume
from test_torch_port_augment import _policy_draws
from test_torch_port_eval import MI_ATOL, PSNR_ATOL, RTOL
from test_torch_port_train import _bn_biases

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
SEED = 0
STEPS = 4  # 8 train slices at batch 2
MOMENT_RTOL = 2e-2
MOMENT_FLOOR = 5e-3


class _Writer:
    """A stand-in for TensorBoard's SummaryWriter that keeps what is
    logged (both CLIs import it where they open the writer)."""

    def __init__(self, logdir):
        self.scalars, self.histograms = [], []

    def add_scalar(self, tag, val, step):
        self.scalars.append((tag, step, float(val)))

    def add_histogram(self, tag, global_step, **kw):
        self.histograms.append((tag, global_step))

    def add_text(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def _route_writers(mp):
    """Route both CLIs' SummaryWriter to `_Writer`s; returns the list they
    are added to."""
    made = []

    def make(logdir):
        made.append(_Writer(logdir))
        return made[-1]

    mp.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=make))
    return made


@pytest.fixture
def writers(monkeypatch):
    return _route_writers(monkeypatch)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_e2e.py's workspace: two T1/T2 pairs of 4 slices at 24²."""
    root = tmp_path_factory.mktemp("train_cli")
    rows = []
    for v in range(2):
        write_h5_volume(str(root / f"p{v}_t1.h5"), "T1", seed=v * 2)
        write_h5_volume(str(root / f"p{v}_t2.h5"), "T2", seed=v * 2 + 1)
        rows.append(f"p{v}_t1.h5,p{v}_t2.h5")
    csv = root / "pairs.csv"
    csv.write_text("\n".join(rows) + "\n")
    return root, str(csv)


def _argv(logdir, csv, reg="Rec", protocals=("T2", "T1"), extra=()):
    """The toy run's flags, the protocol's weights (commands_train_test.sh)."""
    return ["--logdir", str(logdir), "--train", csv, "--val", csv, "--reg", reg,
            "--protocals", *protocals, "--mask", "equispaced", "--sparsity", "0.25",
            "--smooth_weight", "1000", "--gan_weight", "0.1", "--gan_sim_weight", "1",
            "--sim_weight", "1", "--aux_aug", "PBSpline", "--batch_size", "2",
            "--crop", "16", "--epoch", "1", "--intel_stop", "1", "--num_workers", "2",
            "--net_scale", "tiny", "--prefetch", "--seed", str(SEED), *extra]


def _port_args(logdir, csv, **kw):
    return ttrain.build_parser().parse_args(_argv(logdir, csv, **kw) + ["--device", "cpu"])


def _jax_draws(monkeypatch, seed=SEED):
    """Make the port's CLI take the draws the JAX CLI makes: its key
    `PRNGKey(seed)`, split once a step (JAX engine/train.py:283, :319)."""
    state = {"rng": jax.random.PRNGKey(seed)}

    def draw(policy, gen, n, count, device):
        state["rng"], k = jax.random.split(state["rng"])
        return _policy_draws(policy, k, n, count)

    monkeypatch.setattr(ttrain, "draw_augmentation", draw)


@pytest.fixture(scope="module")
def rec_runs(workspace, tmp_path_factory):
    """The JAX and the port CLI, Rec, one epoch from one JAX checkpoint.
    Returns {who: (logdir, logged scalars)} and the checkpoint's path."""
    _, csv = workspace
    root = tmp_path_factory.mktemp("rec_runs")
    start = str(root / "start.pt")
    jargs = jtrain.build_parser().parse_args(_argv(root / "jax", csv) + ["--save_opt"])
    jm = JaxCSModel(cfg=jtrain.build_cfg(jargs), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jax.numpy.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jax.numpy.asarray(np.array([0.05, -0.03], np.float32))
    jm.save(start, with_opt=True)
    jargs.resume = start
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        from spatialalignmentnetwork_tpu.utils import cache

        mp.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
        made = _route_writers(mp)
        jtrain.main(jargs)
        _jax_draws(mp)
        targs = _port_args(root / "port", csv, extra=["--save_opt", "--resume", start])
        ttrain.main(targs)
    for who, w in zip(("jax", "port"), made):
        out[who] = (str(root / who), w.scalars)
    return out, start


def _final(logdir, steps=STEPS):
    return os.path.join(logdir, "ckpt", "ckpt_%010d.pt" % steps)


def checkpoint_failures(got_path, want_path, noise_keys, n=STEPS):
    """The leaves of checkpoint `got_path` that miss the parity bars against
    `want_path` after n steps (see the module's docstring), as messages."""
    got, want = ckpt_load(got_path), jckpt_load(want_path)
    fails = []
    for name in ("net_T", "net_R", "net_G", "net_D", "net_mask"):
        if set(got[name]) != set(want[name]):
            fails.append(f"{name}: keys differ")
            continue
        for key, w in want[name].items():
            w, g = np.asarray(w), np.asarray(got[name][key])
            if name not in ("net_T", "net_R"):  # a Rec step leaves them
                if not np.array_equal(g, w):
                    fails.append(f"{name} {key}: changed")
                continue
            diff = np.abs(g.astype(np.float64) - w)
            if key.startswith("params/"):
                if diff.max() >= 2.5 * LR * n:
                    fails.append(f"{name} {key}: max {diff.max():.3g}")
                if key not in noise_keys and diff.mean() >= 0.7 * LR * n:
                    fails.append(f"{name} {key}: mean {diff.mean():.3g}")
            elif not np.allclose(g, w, rtol=1e-4, atol=LR if key.endswith("/mean") else 0.0):
                fails.append(f"{name} {key}: stats {diff.max():.3g}")
    go, wo = got["opt_state"], want["opt_state"]
    if set(go) != set(wo):
        return fails + ["opt_state: keys differ"]
    net_max = {}
    for key, w in wo.items():
        net, _, slot = key.split("/")[:3]
        if slot in ("mu", "nu"):
            net_max[net, slot] = max(net_max.get((net, slot), 0.0), float(np.abs(w).max()))
    for key, w in wo.items():
        net, _, slot = key.split("/")[:3]
        g = np.asarray(go[key])
        if slot == "count" or net not in ("net_T", "net_R"):
            if not np.array_equal(g, w):
                fails.append(f"opt_state {key}: {g} vs {w}")
            continue
        err = float(np.abs(g.astype(np.float64) - w).max())
        bar = MOMENT_RTOL * float(np.abs(w).max()) + MOMENT_FLOOR * net_max[net, slot]
        if err > bar:
            fails.append(f"opt_state {key}: {err:.3g} > {bar:.3g}")
    return fails


def _val_scalars(scalars):
    return {tag[len("val/"):]: v for tag, _, v in scalars if tag.startswith("val/")}


def test_rec_clis_agree_leaf_by_leaf(rec_runs):
    runs, start = rec_runs
    tm = CSModel(ckpt=start, device="cpu")
    for who in ("jax", "port"):
        names = sorted(os.listdir(os.path.join(runs[who][0], "ckpt")))
        assert names == ["best.pt", "ckpt_%010d.pt" % STEPS], (who, names)
    fails = checkpoint_failures(_final(runs["port"][0]), _final(runs["jax"][0]), _bn_biases(tm))
    assert not fails, fails
    opt = ckpt_load(_final(runs["port"][0]))["opt_state"]
    assert int(opt["net_R/0/count"]) == STEPS and int(opt["net_G/0/count"]) == 0


def _jax_validation(ckpt, csv):
    """The JAX CLI's validation (its engine/train.py:391-406: the val
    slices in batches of 2, `test` and the mean of each scalar) of the JAX
    model loaded from `ckpt`."""
    from spatialalignmentnetwork_tpu.data.loader import Loader as JLoader
    from spatialalignmentnetwork_tpu.data.paired_dataset import (
        ConcatDataset, get_paired_volume_datasets)

    jm = JaxCSModel(ckpt=ckpt)
    jm.eval()
    val = ConcatDataset(get_paired_volume_datasets(csv, crop=16, protocals=["T2", "T1"]))
    stats = []
    for batch in JLoader(val, 2, shuffle=False, drop_last=True, num_workers=2):
        jm.set_input(*batch)
        jm.test()
        stats.append(jm.get_vis("scalars")["scalars"])
    return {k: float(np.mean([x[k] for x in stats])) for k in stats[0]}


def _assert_eval_bars(got, want, what):
    assert set(got) == set(want) and "metric_PSNR" in want, what
    for k, w in want.items():
        bar = PSNR_ATOL if k == "metric_PSNR" else MI_ATOL if k == "metric_MI" else RTOL * abs(w)
        assert abs(got[k] - w) <= bar, f"{what} {k}: {got[k]} vs {w} (bar {bar})"


def test_rec_cli_validation_matches_jax(rec_runs, workspace):
    """The port's epoch-end validation scalars against the JAX CLI's
    validation loop run on the same weights (the port's final checkpoint,
    which that validation scored) at the eval bars; and the two CLIs' own
    logs: the same tags at the same steps, metric_PSNR within the eval bar.
    (Their other scalars differ as far as the weights, within the Adam
    bar, move them: up to 6e-4 relative, metric_MI 1.4e-3, here.)"""
    runs, _ = rec_runs
    _, csv = workspace
    got = _val_scalars(runs["port"][1])
    _assert_eval_bars(got, _jax_validation(_final(runs["port"][0]), csv), "same weights")
    want = _val_scalars(runs["jax"][1])
    assert set(got) == set(want)
    assert abs(got["metric_PSNR"] - want["metric_PSNR"]) <= PSNR_ATOL
    assert sorted((t, s) for t, s, _ in runs["port"][1]) == sorted(
        (t, s) for t, s, _ in runs["jax"][1])


def test_rec_parity_bars_catch_another_batch_order(rec_runs, workspace, tmp_path,
                                                   monkeypatch, writers):
    """The control: the port's CLI on `--seed 1`'s batch order (the draws
    still JAX's of seed 0) misses the bars."""
    runs, start = rec_runs
    _, csv = workspace
    _jax_draws(monkeypatch)
    args = _port_args(tmp_path / "other", csv, extra=["--save_opt", "--resume", start])
    args.seed = 1
    ttrain.main(args)
    fails = checkpoint_failures(_final(str(tmp_path / "other")), _final(runs["jax"][0]),
                                _bn_biases(CSModel(ckpt=start, device="cpu")))
    assert fails


# ------------------------------------------------------------ the protocol
PROTOCOL = (  # commands_train_test.sh:48-65: name, --reg, protocols, source, nets
    ("single", "None", ("T2", "None"), None, None),
    ("multi", "None", ("T2", "T1"), "single", ["net_mask"]),
    ("gan_only", "GAN-Only", ("T2", "T1"), "single", ["net_mask"]),
    ("proposed", "Mixed", ("T2", "T1"), "gan_only", ["net_mask", "net_D", "net_G", "net_T"]),
)


def test_four_stage_protocol_through_main(workspace, tmp_path, monkeypatch, writers):
    """The reference's staged protocol through the port's `main` on h5
    volumes, then one `--resume ""` epoch of the last stage and the port's
    eval CLI on its best.pt. Before each warm-started stage's first step,
    the nets it names equal its checkpoint bit for bit; `--resume ""` takes the iteration count from the
    checkpoint's name and Adam's moments from it."""
    _, csv = workspace
    real_run = ttrain.run
    seen = {}

    def run(net, slices_train, slices_val, args, writer=None, iter_cnt=0):
        seen["net"], seen["iter_cnt"] = net, iter_cnt
        if args.load_nets:
            want, got = ckpt_load(args.resume), net.checkpoint(args.load_nets)
            for name in args.load_nets:
                assert set(got[name]) == set(want[name]), name
                for k, v in want[name].items():
                    np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name} {k}")
        return real_run(net, slices_train, slices_val, args, writer, iter_cnt)

    monkeypatch.setattr(ttrain, "run", run)
    monkeypatch.setattr(ttrain, "SCALARS_EVERY", 1)
    for name, reg, protocals, source, nets in PROTOCOL:
        extra = ["--resume", str(tmp_path / source / "ckpt" / "best.pt"),
                 "--load_nets", *nets] if source else []
        rec = ttrain.main(_port_args(tmp_path / name, csv, reg=reg, protocals=protocals,
                                     extra=extra + ["--save_opt"]))
        assert rec["iter_cnt"] == STEPS and rec["epochs"][0]["steps"] == STEPS
        assert sorted(os.listdir(tmp_path / name / "ckpt")) == ["best.pt", "ckpt_%010d.pt" % STEPS]
        values = [v for _, _, v in rec["scalars"]]
        assert len(values) > STEPS and np.isfinite(values).all(), name
        assert {t for t, _, _ in rec["scalars"]} >= {"train/loss_all", "val/metric_PSNR"}
    assert seen["net"].cfg.reg == "Mixed"

    rec = ttrain.main(_port_args(tmp_path / "proposed", csv, reg="Mixed",
                                 extra=["--resume", "", "--save_opt"]))
    assert seen["iter_cnt"] == STEPS and rec["iter_cnt"] == 2 * STEPS
    assert {int(st["step"]) for st in seen["net"].opt["net_R"].state.values()} == {2 * STEPS}
    assert os.path.isdir(tmp_path / "proposed" / "ckpt" / ("ckpt_%010d.pt" % (2 * STEPS)))
    metric = str(tmp_path / "metrics.json")
    teval.main(teval.build_parser().parse_args([
        "--resume", str(tmp_path / "proposed" / "ckpt" / "best.pt"), "--val", csv,
        "--protocals", "T2", "T1", "--device", "cpu", "--metric", metric]))
    with open(metric) as f:
        volumes = json.load(f)["volumes"]
    assert len(volumes) == 2 and all(np.isfinite(list(v.values())).all() for v in volumes)


def test_cadences_trace_and_native_cache(workspace, tmp_path, monkeypatch, writers):
    """With every cadence at one iteration: the scalars and histograms of
    each step (TensorBoard and the returned log), an image grid of each
    named image a step, a checkpoint a step; `--trace_at 2` writes one
    torch.profiler trace; the data come from native slice caches
    (`--native_cache`), both splits built."""
    _, csv = workspace
    for name in ("SCALARS_EVERY", "IMAGES_EVERY", "CKPT_EVERY"):
        monkeypatch.setattr(ttrain, name, 1)
    log = tmp_path / "log"
    rec = ttrain.main(_port_args(log, csv, extra=[
        "--trace_at", "2", "--native_cache", str(tmp_path / "nc")]))
    writer = writers[0]
    steps = [s for t, s, _ in writer.scalars if t == "train/loss_all"]
    assert steps == list(range(1, STEPS + 1))
    assert writer.scalars == rec["scalars"]
    assert sorted(os.listdir(log / "ckpt")) == ["best.pt"] + [
        "ckpt_%010d.pt" % i for i in range(1, STEPS + 1)]
    images = sorted(os.listdir(log / "res"))
    assert len(images) == STEPS * 9 and images[0].startswith("0000000001_img_")
    assert os.listdir(log / "trace") == ["iter_0000000002.json"]
    for split in ("train", "val"):
        assert sorted(os.listdir(tmp_path / "nc" / split)) == [
            "cache_T1.bin", "cache_T1.bin.counts.json", "cache_T2.bin",
            "cache_T2.bin.counts.json"]


def test_use_amp_trains_as_the_jax_cli(workspace, tmp_path, monkeypatch):
    """`--use_amp` (once refused): both CLIs `--resume`
    one JAX checkpoint of a bf16 model (its STN head non-zero), Rec, one
    epoch of 4 updates on JAX's draws; each update's losses at the bf16
    step bar of tests/test_torch_port_amp.py, the port's checkpoints f32
    under a cfg with use_amp. The JAX package's s2d train layout, which
    the port leaves out, is off (SAN_TPU_S2D_TRAIN=0)."""
    from spatialalignmentnetwork_tpu.utils import cache
    from test_torch_port_amp import LOSS_BAR, loss_dist

    _, csv = workspace
    monkeypatch.setenv("SAN_TPU_S2D_TRAIN", "0")
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    _route_writers(monkeypatch)
    jargs = jtrain.build_parser().parse_args(_argv(tmp_path / "jax", csv) + ["--use_amp"])
    jm = JaxCSModel(cfg=jtrain.build_cfg(jargs), seed=0)
    head = jm.state["params"]["net_T"]["Conv_0"]
    rng = np.random.default_rng(5)
    head["kernel"] = jax.numpy.asarray(
        rng.standard_normal(head["kernel"].shape).astype(np.float32) * 0.05)
    head["bias"] = jax.numpy.asarray(np.array([0.05, -0.03], np.float32))
    start = str(tmp_path / "start.pt")
    jm.save(start, with_opt=True)
    jargs.resume = start
    losses = {"jax": [], "port": []}
    for who, cls in (("jax", JaxCSModel), ("port", CSModel)):
        update = cls.update

        def recorded(self, *a, _update=update, _who=who, **k):
            _update(self, *a, **k)
            losses[_who].append(self.get_vis("scalars")["scalars"])

        monkeypatch.setattr(cls, "update", recorded)
    jtrain.main(jargs)
    _jax_draws(monkeypatch)
    ttrain.main(_port_args(tmp_path / "port", csv, extra=["--use_amp", "--resume", start]))
    assert len(losses["port"]) == len(losses["jax"]) == STEPS
    for step, (got, want) in enumerate(zip(losses["port"], losses["jax"])):
        want = {k: float(v) for k, v in want.items()}
        assert loss_dist(got, want) <= LOSS_BAR, (step, got, want)
    ckpt = ckpt_load(_final(str(tmp_path / "port")))
    assert bool(ckpt["config"].use_amp)
    assert {np.asarray(v).dtype for name in ("net_T", "net_R")
            for v in ckpt[name].values()} == {np.dtype(np.float32)}


def test_load_nets_needs_resume_and_the_card_needs_cuda(workspace, tmp_path, monkeypatch,
                                                        writers):
    _, csv = workspace
    with pytest.raises(ValueError, match="--load_nets needs --resume"):
        ttrain.main(_port_args(tmp_path, csv, extra=["--load_nets", "net_mask"]))
    with pytest.raises(FileNotFoundError, match="no available ckpt"):
        ttrain.main(_port_args(tmp_path / "empty", csv, extra=["--resume", ""]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ttrain.build_parser().parse_args(_argv(tmp_path, csv))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(args)


def test_cli_modules_import_no_jax_and_no_h5py():
    """The card's machine has no JAX and may have no h5py: the train CLI
    and the host data modules import neither (h5py where a file opens)."""
    code = ("import sys\n"
            "import spatialalignmentnetwork_tpu_torch.engine.train\n"
            "import spatialalignmentnetwork_tpu_torch.engine.checkpoint\n"
            "import spatialalignmentnetwork_tpu_torch.data.native_cache\n"
            "import spatialalignmentnetwork_tpu_torch.data.convert\n"
            "import spatialalignmentnetwork_tpu_torch.data.volumefolder\n"
            "import spatialalignmentnetwork_tpu_torch.data.nifti_minimal\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'h5py', 'spatialalignmentnetwork_tpu', 'PIL')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_train_cli_phase_runs_on_cpu(tmp_path):
    """chip_smoke.py's phase 12 (the four stages, `--resume ""` and eval
    through the CLI's `open_model` and `run`) on the CPU at 32x32, tiny
    widths and volumes of 4 slices: its logic is exercised here, its
    numbers only on a card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    launches = chip_smoke.check_train_cli(np.random.default_rng(0), device="cpu", shape=32,
                                          batch=2, net_scale="tiny", slices=4,
                                          workdir=str(tmp_path / "cli"))
    assert launches == {}  # CPU tensors take the plain versions
    assert not os.path.exists(tmp_path / "cli")
    assert chip_smoke.NONE_LAUNCHES == {"grid_sample_fwd": 1, "ssim_fwd": 1, "ssim_bwd": 1}
    assert kernels.LAUNCHES == {}


def test_objects_build_from_the_given_cfg_and_save_only_those(workspace, tmp_path):
    """`CSModel(cfg=, ckpt=, objects=, seed=)`, the CLI's `--load_nets`: the
    named nets from the checkpoint, the others a fresh build of the given
    cfg (not the checkpoint's) from `seed`, no Adam state, as the JAX
    `load`; `save(objects=...)` writes those entries alone, which the JAX
    CSModel loads the same way."""
    _, csv = workspace
    cfg_a = ttrain.build_cfg(_port_args(tmp_path, csv, reg="None"))
    cfg_b = ttrain.build_cfg(_port_args(tmp_path, csv, reg="Mixed"))
    src = CSModel(cfg=cfg_a, device="cpu", seed=1)
    src.pruned = ~src.pruned  # a mask no fresh build has
    path = str(tmp_path / "a")
    src.save(path, with_opt=True)
    got = CSModel(cfg=cfg_b, ckpt=path, objects=["net_mask", "net_T"], device="cpu", seed=3)
    fresh = CSModel(cfg=cfg_b, device="cpu", seed=3).checkpoint()
    assert got.cfg.reg == "Mixed"
    assert torch.equal(got.pruned, src.pruned)
    held, want = got.checkpoint(), src.checkpoint()
    for name in ("net_T", "net_G", "net_D", "net_R"):
        ref = want[name] if name == "net_T" else fresh[name]
        for k, v in ref.items():
            np.testing.assert_array_equal(held[name][k], v, err_msg=f"{name} {k}")
    assert not any(got.opt[name].state for name in got.opt)
    with pytest.raises(ValueError, match="needs a checkpoint"):
        CSModel(cfg=cfg_b, objects=["net_T"], device="cpu")
    part = str(tmp_path / "part")
    got.save(part, objects=["net_T", "net_mask"])
    assert sorted(os.listdir(part)) == ["config", "net_T", "net_mask"]
    jm = JaxCSModel(ckpt=part, cfg=jtrain.build_cfg(jtrain.build_parser().parse_args(
        _argv(tmp_path, csv, reg="Mixed"))), objects=["net_T", "net_mask"])
    np.testing.assert_array_equal(np.asarray(jm.state["pruned"]), src.pruned.numpy())
    with pytest.raises(KeyError, match="net_X"):
        got.save(str(tmp_path / "bad"), objects=["net_X"])
