"""scripts/torch_port_trained_parity.py end to end on the CPU at toy size,
and both port CLIs' `--matmul_precision`.

The card half runs with `--device cpu` at 16x16, `--net_scale tiny`, 2
iterations a stage: the four stages through the train CLI, link 1 (here
the CPU against itself), the readings and the package of the rounded
nets. The host half rebuilds the checkpoint from that package, writes the
val volumes as h5 files and runs both eval CLIs in subprocesses (the JAX
one at `--matmul_precision highest`): their per-volume PSNRs agree within
1e-3 dB, and a planted fault (one net_R weight perturbed in the port's
copy of the checkpoint) fails that comparison.

`--matmul_precision` (the JAX CLIs' levels): all three parse in both port
CLIs; once `main` has built its model, both TF32 switches are on at
"default" and "high" and off at "highest" and without the flag, and off
again after `main`; the eval metrics file's `meta` records the level; on
the CPU, where the switches act on nothing, the outputs are the same bits
with the flag and without it.

TensorFlow, which TensorBoard's import would pull in (about 20 s), is kept
out of the train CLI's writer.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from spatialalignmentnetwork_tpu_torch.engine import eval as teval
from spatialalignmentnetwork_tpu_torch.engine import train as ttrain
from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_port_trained_parity as parity  # noqa: E402

torch.set_num_threads(2)
SHAPE = 16
CARD = ["--device", "cpu", "--shape", str(SHAPE), "--net_scale", "tiny", "--train_volumes",
        "1", "--val_volumes", "2", "--slices", "4", "--batch", "2", "--iters", "2", "2", "2",
        "2"]
LEVELS = (None, "default", "high", "highest")


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both halves, card then host: (exit codes, the output directory, the
    work directory)."""
    out = str(tmp_path_factory.mktemp("out"))
    work = str(tmp_path_factory.mktemp("work"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        card = parity.main(["card", *CARD, "--out", out, "--work", work])
    host = parity.main(["host", "--out", out, "--work", work, "--threads", "2"])
    return (card, host), out, work


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_card_half_trains_the_four_stages_and_packs_the_rounded_nets(runs):
    (card, _), out, work = runs
    assert card == 0
    summary = _read(os.path.join(out, "summary.json"))
    assert [s["stage"] for s in summary["stages"]] == ["Single-Modal", "Multi-Modal",
                                                      "GAN-Only", "Proposed"]
    assert all(s["iterations"] >= 2 and s["launches"] == {} for s in summary["stages"])
    assert summary["link1"]["misses"] == [] and summary["link1"]["rounded_misses"] == []
    readings = summary["readings"]
    assert len(readings["sens_min_median_max"]) == 2 and readings["sens_min"] > 0
    assert readings["psnr_tf32_minus_f32"] == [0.0, 0.0]  # TF32 acts on nothing here
    assert all(np.isfinite(readings["psnr_bf16_minus_f32"]))
    assert all(abs(d) < 1e-3 for d in readings["psnr_rounded_minus_exact"])
    for name in parity.SCORINGS:
        assert len(_read(os.path.join(out, f"metrics_{name}.json"))["volumes"]) == 2
    best = ckpt_load(os.path.join(work, "card", "Proposed", "ckpt", "best.pt"))
    got = parity.unpack(os.path.join(out, "package.npz"), summary["package"]["layout"])
    assert parity.entries_sha(got) == summary["package"]["entries_sha256"]
    for net in parity.ROUNDED_NETS:
        for key, want in best[net].items():
            assert got[net][key].dtype == want.dtype
            np.testing.assert_allclose(got[net][key], want, rtol=2**-16, atol=0)
    np.testing.assert_array_equal(got["net_mask"]["pruned"], best["net_mask"]["pruned"])


def test_round24_rounds_to_nearest_even_and_pack_refuses_unrounded_values(tmp_path):
    u = np.array([0x3F800080, 0x3F800180, 0x3F80007F, 0xBF8001C0, 0x3F8000FF], np.uint32)
    got = parity.round24(u.view(np.float32)).view(np.uint32)
    # a tie rounds to the even neighbour, either way; below half down; the
    # sign apart
    np.testing.assert_array_equal(
        got, np.array([0x3F800000, 0x3F800200, 0x3F800000, 0xBF800200, 0x3F800100],
                      np.uint32))
    entries = {"net_T": {"params/w": parity.round24(np.linspace(-1, 1, 7, dtype=np.float32)),
                         "params/n": np.arange(3, dtype=np.int32)},
               "net_mask": {"pruned": np.array([True, False])}}
    layout = parity.pack(entries, str(tmp_path / "p.npz"))
    back = parity.unpack(str(tmp_path / "p.npz"), layout)
    assert parity.entries_sha(back) == parity.entries_sha(entries)
    with pytest.raises(ValueError, match="not rounded"):
        parity.pack({"net_T": {"params/w": np.float32([0.1])}}, str(tmp_path / "q.npz"))


def test_host_half_both_eval_clis_agree(runs):
    (_, host), out, work = runs
    assert host == 0
    report = _read(os.path.join(out, "host.json"))
    assert report["volumes"] == 2 and report["val_sha256_match"]
    assert report["parity"] and report["toy"]
    for row in report["link2"]:
        assert abs(row["diff"]["metric_PSNR"]) <= parity.TOY_DB
    assert all(abs(d) <= parity.TOY_DB for d in report["port_here_minus_card_machine_cpu_psnr"])
    assert all(abs(d) <= parity.TOY_DB for d in report["saved_psnr_port_minus_jax"])
    jax_meta = _read(os.path.join(work, "host", "jax.json"))["meta"]
    assert jax_meta["matmul_precision"] == "highest"
    assert _read(os.path.join(work, "host", "port.json"))["meta"]["device"] == "cpu"


def test_a_perturbed_net_r_weight_fails_the_comparison(runs, tmp_path):
    _, _, work = runs
    host = os.path.join(work, "host")
    bad = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(host, "ckpt"), bad)
    with np.load(os.path.join(bad, "net_R")) as z:
        entry = dict(z)
    key = next(k for k in sorted(entry) if k.endswith("kernel"))
    entry[key] = entry[key].copy()
    entry[key].flat[0] += 1.0
    with open(os.path.join(bad, "net_R"), "wb") as f:
        np.savez(f, **entry)
    metric = str(tmp_path / "port.json")
    teval.main(teval.build_parser().parse_args(
        ["--resume", bad, "--val", os.path.join(host, "data", "pairs.csv"), "--protocals",
         "T2", "T1", "--metric", metric, "--device", "cpu"]))
    rows = parity.compare(parity.read_metrics(metric),
                          parity.read_metrics(os.path.join(host, "jax.json")))
    assert not all(r["toy"] for r in rows), [r["diff"]["metric_PSNR"] for r in rows]


# ------------------------------------------------------- --matmul_precision
@pytest.mark.parametrize("cli", [ttrain, teval], ids=["train", "eval"])
def test_matmul_precision_parses_the_jax_levels(cli):
    base = (["--resume", "x", "--val", "v"] if cli is teval else
            ["--logdir", "l", "--train", "t", "--val", "v", "--reg", "Rec",
             "--smooth_weight", "1", "--gan_weight", "0", "--gan_sim_weight", "0",
             "--sim_weight", "1", "--mask", "equispaced", "--aux_aug", "None"])
    parser = cli.build_parser()
    assert parser.parse_args(base).matmul_precision is None
    for level in LEVELS[1:]:
        assert parser.parse_args(base + ["--matmul_precision", level]).matmul_precision == level
    with pytest.raises(SystemExit):
        parser.parse_args(base + ["--matmul_precision", "bf16"])


def _eval_argv(work, metric, level, save=None):
    host = os.path.join(work, "host")
    argv = ["--resume", os.path.join(host, "ckpt"), "--val", os.path.join(host, "data",
            "pairs.csv"), "--protocals", "T2", "T1", "--metric", metric, "--device", "cpu"]
    if save:
        argv += ["--save", save]
    return argv + (["--matmul_precision", level] if level else [])


def test_eval_cli_holds_the_level_records_it_and_keeps_the_bits(runs, tmp_path, monkeypatch):
    _, _, work = runs
    seen = []

    def evaluate(net, *a, **k):
        seen.append(_tf32())
        return real(net, *a, **k)

    real = teval.evaluate
    monkeypatch.setattr(teval, "evaluate", evaluate)
    out = {}
    for level in LEVELS:
        metric = str(tmp_path / f"{level}.json")
        save = str(tmp_path / f"{level}_save") if level in (None, "high") else None
        teval.main(teval.build_parser().parse_args(_eval_argv(work, metric, level, save)))
        tf32 = level in ("default", "high")
        assert seen.pop() == (tf32, tf32), level
        assert _tf32() == (False, False), level
        out[level] = _read(metric)
        assert out[level]["meta"]["matmul_precision"] == level
    assert all(out[level]["volumes"] == out[None]["volumes"] for level in LEVELS)
    names = sorted(os.listdir(tmp_path / "None_save"))
    assert names == sorted(os.listdir(tmp_path / "high_save")) and names
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "high_save" / name),
                                      np.load(tmp_path / "None_save" / name))


def _train_argv(logdir, level):
    argv = ["--logdir", logdir, "--train", "mem", "--val", "mem", "--reg", "Rec",
            "--protocals", "T2", "T1", "--mask", "equispaced", "--sparsity", "0.25",
            "--smooth_weight", "1000", "--gan_weight", "0.1", "--gan_sim_weight", "1",
            "--sim_weight", "1", "--aux_aug", "PBSpline", "--batch_size", "2", "--crop",
            str(SHAPE), "--epoch", "1", "--num_workers", "0", "--net_scale", "tiny",
            "--seed", "0", "--device", "cpu"]
    return argv + (["--matmul_precision", level] if level else [])


def test_train_cli_holds_the_level_and_keeps_the_bits(runs, tmp_path, monkeypatch):
    """Each level through `main` (its `run` records the switches, then
    trains two steps of Rec on the card half's volumes); the checkpoints
    without the flag and at "high" hold the same bits."""
    _, out, _ = runs
    summary = _read(os.path.join(out, "summary.json"))
    a = summary["args"]
    train, val = parity.volumes(a["seed"], a["shape"], a["train_volumes"], a["val_volumes"],
                                a["slices"])
    import chip_smoke

    datasets = (chip_smoke.cli_slices(train), chip_smoke.cli_slices(val))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    seen = []

    def run(net, *args, **kw):
        seen.append(_tf32())
        return real(net, *args, **kw)

    real = ttrain.run
    monkeypatch.setattr(ttrain, "run", run)
    for level in LEVELS:
        logdir = str(tmp_path / str(level))
        ttrain.main(ttrain.build_parser().parse_args(_train_argv(logdir, level)),
                    datasets=datasets)
        tf32 = level in ("default", "high")
        assert seen.pop() == (tf32, tf32), level
        assert _tf32() == (False, False), level
    want = ckpt_load(str(tmp_path / "None" / "ckpt" / "ckpt_0000000002.pt"))
    got = ckpt_load(str(tmp_path / "high" / "ckpt" / "ckpt_0000000002.pt"))
    for net in ("net_T", "net_R", "net_mask"):
        assert set(got[net]) == set(want[net])
        for key, w in want[net].items():
            np.testing.assert_array_equal(got[net][key], w, err_msg=f"{net} {key}")
