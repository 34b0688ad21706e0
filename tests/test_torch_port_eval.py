"""The PyTorch port's eval path against the JAX package, on the CPU: the
test step (`CSModel.test`, unmasked and bucketed), `get_vis`, the data
layer, the reference's checkpoint layouts, `load(objects=...)` and the two
eval CLIs end to end.

One tiny JAX CSModel a regime (reg "Rec" and "Mixed", built once for the
module) takes two updates, so that net_T's head is no longer zero and
the warp moves the reference; it is saved and the port loads the
checkpoint, so both hold the same weights, statistics and mask. Bars:

  * loss_* and metric_* rtol 1e-4, metric_PSNR within 1e-3 dB (f32 sums
    in another order; far inside the 0.1 dB bar of the port's "Done");
    metric_MI within 1e-5 (the same 64-bin histograms, then f32 sums in
    another order: a pixel that the two rounded to either side of a bin
    edge would move it by a step, which these inputs do not hold);
  * images rtol 1e-4, atol 1e-5 of each image's max |value| (net_G's
    outputs run to 1e8 in the Rec model, whose net_G keeps the spectral
    vectors of its fresh build); the reconstruction at the serving bar of
    tests/test_torch_port_serve.py, rtol 1e-3, atol 1e-4 (net_R's f32
    sums in another order: 4.5e-5 on a reconstruction of max 2.3 here).

A bucketed volume's scalars equal the unpadded volume's (the JAX
package's claim, its csmodel.py:872-874), also when a pad slice comes out
NaN. `--aux_aug` is held with the draws JAX's `scaled_deformation` makes
from the key the JAX CLI seeds (its clock, fixed here), passed through
`evaluate(draws=...)`. Inputs come from numpy seeds.
"""

import argparse
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatialalignmentnetwork_tpu.data import paired_dataset as jdata
from spatialalignmentnetwork_tpu.engine import eval as jeval
from spatialalignmentnetwork_tpu.engine.checkpoint import ckpt_load as jckpt_load
from spatialalignmentnetwork_tpu.engine.config import Config as JaxConfig
from spatialalignmentnetwork_tpu.engine.csmodel import CSModel as JaxCSModel

from spatialalignmentnetwork_tpu_torch.data import paired_dataset as tdata
from spatialalignmentnetwork_tpu_torch.engine import eval as teval
from spatialalignmentnetwork_tpu_torch.engine.config import Config
from spatialalignmentnetwork_tpu_torch.engine.csmodel import NETS, CSModel
from spatialalignmentnetwork_tpu_torch.models import layers

from conftest import write_h5_volume
from test_torch_port_augment import _jax_draws

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = 16
RTOL = 1e-4
PSNR_ATOL = 1e-3
MI_ATOL = 1e-5
IMG_RTOL = 1e-4
IMG_ATOL_REL = 1e-5
REC_TOL = dict(rtol=1e-3, atol=1e-4)  # net_R's output, the serving bar
BUCKET = 4
VOLUME_SLICES = (3, 5)


def _cfg(reg, mask="equispaced"):
    """tests/test_torch_port_serve.py::tiny_cfg with two cascades."""
    return Config(
        sparsity=0.25, lr=1e-4, shape=SHAPE, coils=1, reg=reg, mask=mask,
        weight_smooth=1000.0, weight_gan=0.1, weight_gan_sim=1.0, weight_sim=1.0,
        net_G_layers=(4, 8), net_D_blocks=((4,), (8,)), net_T_layers=(4, 8),
        net_R_cascades=2, net_R_chans=4, net_R_sens_chans=4, net_R_pools=1,
        net_R_sens_pools=1,
    )


def _batch(seed, n=3, shape=SHAPE):
    rng = np.random.default_rng(200 + seed)
    mk = lambda: (rng.random((n, 1, shape, shape))
                  + 1j * rng.random((n, 1, shape, shape))).astype(np.complex64)
    return mk(), mk()


@pytest.fixture(scope="module", params=["Rec", "Mixed"])
def trained(request, tmp_path_factory):
    """A tiny JAX model of one regime after two updates, saved (with its
    optimizer state), in eval mode."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg(request.param).to_dict()), seed=0)
    for seed in (0, 1):
        jm.set_input(*_batch(seed, n=2))
        jm.update()
    head = np.asarray(jm.state["params"]["net_T"]["Conv_0"]["kernel"])
    assert np.abs(head).max() > 0
    path = str(tmp_path_factory.mktemp("eval") / request.param)
    jm.save(path, with_opt=True)
    jm.eval()
    return jm, path


def _port(path, **kw):
    tm = CSModel(ckpt=path, device="cpu", **kw)
    tm.eval()
    return tm


def _assert_scalars(got, want, what=""):
    assert set(got) == set(want), f"{what}: {sorted(got)} vs {sorted(want)}"
    for k, w in want.items():
        bar = (PSNR_ATOL if k == "metric_PSNR" else MI_ATOL if k == "metric_MI"
               else RTOL * abs(w))
        assert abs(got[k] - w) <= bar, f"{what} {k}: {got[k]} vs {w} (bar {bar})"


def _image_tol(name, want):
    if name in ("img_rec", "rec"):
        return REC_TOL
    return dict(rtol=IMG_RTOL, atol=IMG_ATOL_REL * float(np.abs(want).max()))


def _assert_images(got, want, what=""):
    assert set(got) == set(want), f"{what}: {sorted(got)} vs {sorted(want)}"
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        np.testing.assert_allclose(got[k], w, err_msg=f"{what} {k}", **_image_tol(k, w))


def _test(model, full, aux, valid=None):
    model.set_input(full, aux)
    ret = model.test(valid=valid)
    return ret, model.get_vis("scalars")["scalars"]


# ------------------------------------------------------------ test step
def test_test_step_matches_jax(trained):
    """Unmasked: every loss_* and metric_*, the return value and every
    get_vis image; loss_sim and metric_SSIM from one SSIM forward."""
    jm, path = trained
    tm = _port(path)
    full, aux = _batch(10)
    rj, sj = _test(jm, full, aux)
    rt, st = _test(tm, full, aux)
    _assert_scalars(st, sj, "unmasked")
    assert abs(rt - rj) <= PSNR_ATOL and rt == -st["metric_PSNR"]
    assert abs(st["loss_sim"] - (1.0 - st["metric_SSIM"])) < 1e-6
    vis_t, vis_j = tm.get_vis(), jm.get_vis()
    assert set(vis_t) == set(vis_j) == {"scalars", "images", "histograms"}
    _assert_images(vis_t["images"], vis_j["images"], "unmasked")
    assert vis_t["histograms"] == vis_j["histograms"] == {}


def test_bucketed_step_matches_jax_and_the_unpadded_step(trained):
    """Masked, on a volume padded to the bucket: the scalars equal JAX's
    masked step's and the port's own unpadded step's, and the real slices'
    images (restored from the padded layout) the unpadded images."""
    jm, path = trained
    tm = _port(path)
    full, aux = _batch(11)
    (pf, pa), valid, restore = teval._bucket_pad([full, aux], BUCKET)
    assert pf.shape[0] == BUCKET and valid.sum() == 3
    _, sj = _test(jm, pf, pa, valid)
    _, st = _test(tm, pf, pa, valid)
    _assert_scalars(st, sj, "masked vs JAX")
    padded_images = tm.get_vis("images")["images"]
    _, s_unpadded = _test(tm, full, aux)
    _assert_scalars(st, s_unpadded, "masked vs unpadded")
    images = tm.get_vis("images")["images"]
    _assert_images({k: v[restore] for k, v in padded_images.items()}, images,
                   "padded vs unpadded")


def test_a_nan_pad_slice_does_not_reach_the_scalars(trained):
    """A pad slice is all zeros. Here net_G's input first goes through an
    instance norm without epsilon, which turns a zero plane into NaN: the
    pad slice's synthesis and aligned image come out NaN (net_R's rss maps
    NaN to 0, so its reconstruction stays 0). sum(per_slice * w) would be
    NaN (0 * NaN); the port drops pad slices instead, so the scalars stay
    the unpadded step's with the same norm."""
    _, path = trained
    tm = _port(path)
    net_g = tm.net_G.forward
    tm.net_G.forward = lambda x: net_g(layers.instance_norm(x, eps=0.0))
    full, aux = _batch(12)
    (pf, pa), valid, restore = teval._bucket_pad([full, aux], BUCKET)
    _, st = _test(tm, pf, pa, valid)
    aligned = tm.get_vis("images")["images"]["img_aligned"]
    pad = np.flatnonzero(valid == 0)
    assert np.isnan(aligned[pad]).all() and np.isfinite(aligned[restore]).all()
    per_slice = torch.abs(torch.from_numpy(aligned) - tm._aux["img_full_rss"]).mean(
        dim=(1, 2, 3))
    assert torch.isnan((per_slice * torch.from_numpy(valid)).sum())
    assert all(np.isfinite(v) for v in st.values())
    _, s_unpadded = _test(tm, full, aux)
    _assert_scalars(st, s_unpadded, "NaN pad vs unpadded")


def test_gan_only_returns_minus_mi(trained):
    jm, path = trained
    tm = _port(path)
    full, aux = _batch(13)
    jm.cfg.reg = "GAN-Only"
    try:
        rj, sj = _test(jm, full, aux)
    finally:
        jm.cfg.reg = tm.cfg.reg
    tm.cfg.reg = "GAN-Only"
    rt, st = _test(tm, full, aux)
    assert rt == -st["metric_MI"] and rj == -sj["metric_MI"]
    assert abs(rt - rj) <= MI_ATOL


def test_test_refuses_train_mode_and_dispatches_without_sync(trained):
    _, path = trained
    tm = CSModel(ckpt=path, device="cpu")
    tm.set_input(*_batch(14))
    with pytest.raises(RuntimeError, match="eval mode"):
        tm.test()
    tm.eval()
    assert tm.test(sync=False) is None
    assert torch.isfinite(tm._aux["metric_PSNR"])
    with pytest.raises(ValueError, match="unknown get_vis"):
        tm.get_vis("losses")
    with pytest.raises(RuntimeError, match="needs a batch"):
        CSModel(ckpt=path, device="cpu").eval().test()


def test_histograms_carry_the_mask_weight(tmp_path):
    """A checkpoint whose mask kind has a weight (kind "mask", all ones):
    get_vis("histograms") shows it as the JAX package does."""
    jm = JaxCSModel(cfg=JaxConfig(**_cfg("Rec", mask="mask").to_dict()), seed=0)
    jm.save(str(tmp_path / "m"))
    tm = _port(str(tmp_path / "m"))
    want = jm.get_vis("histograms")["histograms"]
    got = tm.get_vis("histograms")["histograms"]
    assert set(got) == set(want) == {"weights"}
    np.testing.assert_array_equal(got["weights"]["values"], np.asarray(want["weights"]["values"]))


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 7, 16, 17])
@pytest.mark.parametrize("bucket", [4, 16])
def test_bucket_pad_matches_jax(s, bucket):
    arrays = [np.arange(s * 2, dtype=np.float32).reshape(s, 2) + 1,
              np.ones((s, 1, 3), np.complex64) * (np.arange(s)[:, None, None] + 1)]
    got, valid, restore = teval._bucket_pad(arrays, bucket)
    want, jvalid, jrestore = jeval._bucket_pad(arrays, bucket)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(restore, jrestore)
    for g, w, a in zip(got, want, arrays):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g[restore], a)


# ------------------------------------------------------------ data layer
@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two paired volumes (T1 and T2 h5 files) of 3 and 5 slices, 24x24,
    and their CSV (target T2, reference T1)."""
    root = tmp_path_factory.mktemp("volumes")
    rows = []
    for v, slices in enumerate(VOLUME_SLICES):
        for proto, seed in (("T1", 2 * v), ("T2", 2 * v + 1)):
            write_h5_volume(str(root / f"p{v}_{proto}.h5"), proto,
                            shape=(slices, 24, 24), seed=seed)
        rows.append(f"p{v}_T1.h5,p{v}_T2.h5")
    csv = root / "pairs.csv"
    csv.write_text("\n".join(rows) + "\n")
    return root, str(csv)


@pytest.mark.parametrize("crop,protocals,q", [
    (16, ["T2", "T1"], 0), (17, ["T1", "None"], 0), (30, ["T2"], 0.2), (None, ["T1", "T2"], 0)])
def test_paired_volumes_match_jax(volumes, crop, protocals, q):
    _, csv = volumes
    got = tdata.get_paired_volume_datasets(csv, protocals=protocals, crop=crop, q=q)
    want = jdata.get_paired_volume_datasets(csv, protocals=protocals, crop=crop, q=q)
    assert [len(v) for v in got] == [len(v) for v in want]
    for gv, wv in zip(got, want):
        for i in range(len(wv)):
            for g, w in zip(gv[i], wv[i], strict=True):
                assert g.dtype == np.complex64
                np.testing.assert_array_equal(g, w)
    flat = tdata.ConcatDataset(got)
    assert len(flat) == sum(len(v) for v in got)
    np.testing.assert_array_equal(flat[-1][0], got[-1][len(got[-1]) - 1][0])


def test_flattened_channels_match_jax(tmp_path):
    write_h5_volume(str(tmp_path / "a.h5"), "T1", shape=(2, 3, 20, 20), seed=1)
    write_h5_volume(str(tmp_path / "b.h5"), "T2", shape=(2, 3, 20, 20), seed=2)
    kw = dict(protocals=["T2", "T1"], crop=16, flatten_channels=True)
    got = tdata.AlignedVolumesDataset(str(tmp_path / "a.h5"), str(tmp_path / "b.h5"), **kw)
    want = jdata.AlignedVolumesDataset(str(tmp_path / "a.h5"), str(tmp_path / "b.h5"), **kw)
    assert len(got) == len(want) == 6
    for i in range(6):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)


def test_data_and_eval_modules_import_no_h5py():
    """The card's machine may have no h5py: the eval CLI and the data layer
    import it only where a file is opened."""
    code = ("import sys\n"
            "import spatialalignmentnetwork_tpu_torch.engine.eval\n"
            "import spatialalignmentnetwork_tpu_torch.data.paired_dataset\n"
            "assert 'h5py' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------------------ checkpoints
def _reference_dicts(tm):
    """The port model's state dicts, as the reference saves them: every
    net under its torch names, net_mask with `pruned` and the all-ones
    `weight` that the reference's fixed masks carry."""
    out = {name: {k: v.clone() for k, v in getattr(tm, name).state_dict().items()}
           for name in NETS}
    out["net_mask"] = {"pruned": tm.pruned.clone(),
                       "weight": torch.ones(tm.pruned.shape[0])}
    return out


def _write_layout(tm, layout, root):
    """Write `tm` in one of the reference's layouts; returns its path."""
    sds = _reference_dicts(tm)
    path = os.path.join(root, layout)
    if layout == "file":
        torch.save({**sds, "config": tm.cfg.to_dict()}, path)
        return path
    os.makedirs(path)
    for name, sd in sds.items():
        entry = os.path.join(path, name)
        if layout == "npz":
            with open(entry, "wb") as f:
                np.savez(f, **{k: v.numpy() for k, v in sd.items()})
        else:
            torch.save(sd, entry, _use_new_zipfile_serialization=(layout == "torch_zip"))
    tm.cfg.save(os.path.join(path, "config"))
    return path


@pytest.mark.parametrize("layout", ["torch_legacy", "npz", "file"])
def test_reference_checkpoint_layouts_load_in_both(trained, layout, tmp_path):
    """The port's state dicts in a reference layout: the JAX CSModel loads
    it through torch_compat and the port by its torch names; reconstruct
    and test agree with each other and with the native checkpoint's."""
    _, path = trained
    native = _port(path)
    ckpt = _write_layout(native, layout, str(tmp_path))
    tm = _port(ckpt)
    jm = JaxCSModel(ckpt=ckpt)
    jm.eval()
    for name in NETS:
        for k, v in native_sd(native, name).items():
            assert torch.equal(getattr(tm, name).state_dict()[k], v), (name, k)
    assert tm.net_mask.weight is None  # a fixed mask's weight is dropped, as in JAX
    full, aux = _batch(15)
    want_rec = native.reconstruct(full, aux)
    assert torch.equal(tm.reconstruct(full, aux), want_rec)
    np.testing.assert_allclose(np.asarray(jm.reconstruct(full, aux)), want_rec.numpy(),
                               **REC_TOL)
    _, s_native = _test(native, full, aux)
    _, st = _test(tm, full, aux)
    assert st == s_native
    _, sj = _test(jm, full, aux)
    _assert_scalars(st, sj, layout)


def native_sd(model, name):
    return getattr(model, name).state_dict()


def test_torch_zip_entries_load_in_the_port(trained, tmp_path):
    """A directory of zip-format torch files (torch.save's default): the
    port reads each entry as a state dict. The JAX package's loader takes
    such a file for an npz (numpy opens any zip) and returns its members'
    raw bytes, so only the port is held here."""
    _, path = trained
    native = _port(path)
    ckpt = _write_layout(native, "torch_zip", str(tmp_path))
    assert any(k.endswith("data.pkl") for k in jckpt_load(ckpt)["net_T"])
    tm = _port(ckpt)
    for name in NETS:
        for k, v in native_sd(native, name).items():
            assert torch.equal(getattr(tm, name).state_dict()[k], v), (name, k)
    full, aux = _batch(16)
    assert torch.equal(tm.reconstruct(full, aux), native.reconstruct(full, aux))


def test_a_state_dict_name_the_module_lacks_is_refused(trained, tmp_path):
    _, path = trained
    native = _port(path)
    ckpt = _write_layout(native, "npz", str(tmp_path))
    with np.load(os.path.join(ckpt, "net_T")) as z:
        sd = {k: z[k] for k in z.files}
    sd["unet.extra.weight"] = sd.pop(next(k for k in sd if k.endswith("running_mean")))
    with open(os.path.join(ckpt, "net_T"), "wb") as f:
        np.savez(f, **sd)
    with pytest.raises(RuntimeError, match="state_dict"):
        _port(ckpt)


def test_load_objects_loads_only_those_nets(trained):
    """load(objects=["net_T", "net_R"]): those nets from the checkpoint, the
    others as a fresh build; Adam's state only with objects=None. The JAX
    model loaded the same way reconstructs alike (net_G takes no part)."""
    jm, path = trained
    full_load = CSModel(ckpt=path, device="cpu")
    part = CSModel(cfg=full_load.cfg, device="cpu")
    fresh = CSModel(cfg=full_load.cfg, device="cpu")
    part.load(path, objects=["net_T", "net_R"])
    for name in NETS:
        source = full_load if name in ("net_T", "net_R") else fresh
        for k, v in native_sd(source, name).items():
            assert torch.equal(native_sd(part, name)[k], v), (name, k)
    assert any(full_load.opt["net_R"].state.values())
    assert not any(part.opt[name].state for name in NETS)
    with pytest.raises(KeyError, match="net_X"):
        part.load(path, objects=["net_X"])
    jpart = JaxCSModel(cfg=JaxConfig(**full_load.cfg.to_dict()), seed=0)
    jpart.load(path, objects=["net_T", "net_R"])
    full, aux = _batch(17)
    want = np.asarray(jpart.reconstruct(full, aux))
    np.testing.assert_allclose(part.reconstruct(full, aux).numpy(), want, **REC_TOL)


# ------------------------------------------------------------ the CLIs
def _no_jax_cache(monkeypatch):
    """The JAX CLI points JAX's compile cache under $HOME; keep the tests'."""
    from spatialalignmentnetwork_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)


def _jax_main(monkeypatch, **kw):
    _no_jax_cache(monkeypatch)
    args = dict(crop=SHAPE, protocals=["T2", "T1"], aux_aug=-1.0, bucket=BUCKET,
                data_parallel=False, save=None, metric=None)
    args.update(kw)
    return jeval.main(argparse.Namespace(**args))


def _port_main(resume, val, save=None, metric=None):
    argv = ["--resume", resume, "--val", val, "--protocals", "T2", "T1",
            "--bucket", str(BUCKET), "--device", "cpu", "--crop", str(SHAPE)]
    if save:
        argv += ["--save", save]
    if metric:
        argv += ["--metric", metric]
    return teval.main(teval.build_parser().parse_args(argv))


def test_eval_clis_agree_end_to_end(trained, volumes, monkeypatch, tmp_path):
    """Both CLIs score the same checkpoint on two h5 volumes (3 and 5
    slices, bucket 4: the first pads): per-volume metrics JSONs at the
    bars, the --save volumes at the image bars."""
    _, path = trained
    _, csv = volumes
    out = {}
    for who in ("jax", "port"):
        save, metric = str(tmp_path / f"{who}_out"), str(tmp_path / f"{who}.json")
        if who == "jax":
            _jax_main(monkeypatch, resume=path, val=csv, save=save, metric=metric)
        else:
            _port_main(path, csv, save=save, metric=metric)
        with open(metric) as f:
            out[who] = json.load(f)
    assert out["port"]["meta"]["device"] == "cpu"
    assert out["port"]["meta"]["checkpoint"] == os.path.abspath(path)
    assert len(out["port"]["volumes"]) == len(out["jax"]["volumes"]) == 2
    for i, (got, want) in enumerate(zip(out["port"]["volumes"], out["jax"]["volumes"])):
        _assert_scalars(got, want, f"volume {i}")
    names = sorted(os.listdir(tmp_path / "jax_out"))
    assert names == sorted(os.listdir(tmp_path / "port_out")) and len(names) == 12
    for name in names:
        want = np.load(tmp_path / "jax_out" / name)
        got = np.load(tmp_path / "port_out" / name)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, err_msg=name,
                                   **_image_tol(name.split("_")[1].split(".")[0], want))
    assert np.load(tmp_path / "port_out" / "1_rec.nii.npy").shape == (5, SHAPE, SHAPE)


def test_eval_cli_aux_aug_from_jax_draws(trained, volumes, monkeypatch, tmp_path):
    """--aux_aug 1: the JAX CLI with its clock fixed, the port's `evaluate`
    with the draws JAX's `scaled_deformation` makes from the same keys (one
    a volume, of the padded slice count) on volumes cropped to 1.1x."""
    _, path = trained
    _, csv = volumes
    clock = 1_700_000_000.0
    monkeypatch.setattr(jeval, "time", types.SimpleNamespace(time=lambda: clock))
    metric = str(tmp_path / "jax.json")
    _jax_main(monkeypatch, resume=path, val=csv, metric=metric, aux_aug=1.0)
    with open(metric) as f:
        want = json.load(f)["volumes"]
    rng = jax.random.PRNGKey(int(clock))
    draws = []
    for slices in VOLUME_SLICES:
        rng, k = jax.random.split(rng)
        draws.append(_jax_draws(k, -(-slices // BUCKET) * BUCKET))
    tm = _port(path)
    crop = int(SHAPE * 1.1)
    vols = tdata.get_paired_volume_datasets(csv, protocals=["T2", "T1"], crop=crop)
    assert vols[0][0][0].shape == (1, crop, crop)
    got = teval.evaluate(tm, vols, BUCKET, 1.0, None, draws=draws)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_scalars(g, w, f"aux_aug volume {i}")
    plain = teval.evaluate(tm, tdata.get_paired_volume_datasets(
        csv, protocals=["T2", "T1"], crop=SHAPE), BUCKET, -1.0, None)
    assert plain[0]["metric_MI"] != got[0]["metric_MI"]  # the draws moved the reference


def test_port_cli_refuses_a_missing_checkpoint_and_no_volumes(trained, tmp_path):
    _, path = trained
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(FileNotFoundError):
        _port_main(str(tmp_path / "nope"), str(empty))
    metric = str(tmp_path / "m.json")
    with pytest.raises(ValueError, match="no volumes"):
        _port_main(path, str(empty), metric=metric)
    assert not os.path.exists(metric)


def test_port_cli_needs_a_card_unless_asked_for_the_cpu(trained, volumes, monkeypatch):
    _, path = trained
    _, csv = volumes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = teval.build_parser().parse_args(["--resume", path, "--val", csv])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.main(args)


def test_chip_smoke_eval_phase_runs_on_cpu():
    """chip_smoke.py's eval phase (random weights for net_T, net_R and
    net_G, `evaluate` over phantom volumes, the CPU-vs-CPU and float64
    comparison) at full widths but 32x32 and fewer slices, on the CPU: its
    logic is exercised here, its numbers only on a card."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    launches = chip_smoke.check_eval(np.random.default_rng(0), device="cpu", shape=32,
                                     slices=(5, 4), bucket=4)
    assert launches == {}  # CPU tensors take the plain versions
    assert chip_smoke.EVAL_LAUNCHES == {"grid_sample_fwd": 2, "ssim_fwd": 1}
