"""The PyTorch port's host data path against the JAX package, on the CPU:
`data/loader.py` (`Loader`, `Prefetch`, `device_prefetch`),
`data/native_cache.py` (the port's own build of native/slicecache.cpp),
`data/convert.py` with `data/nifti_minimal.py`, `data/volumefolder.py`,
`utils/visualize.py` and the checkpoint re-pack CLI
(`engine/checkpoint.py`).

All of it is numpy on the host, so the bar is equality: the same batches
in the same order for a seed, byte-equal cache files, equal h5 contents,
equal MI values (the same float64 sums), equal image grids, and a
re-packed checkpoint whose every array equals the source's. Inputs come
from numpy seeds.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spatialalignmentnetwork_tpu.data import convert as jconvert
from spatialalignmentnetwork_tpu.data import loader as jloader
from spatialalignmentnetwork_tpu.data import native_cache as jnative
from spatialalignmentnetwork_tpu.data import nifti_minimal as jnifti
from spatialalignmentnetwork_tpu.data import volumefolder as jvf
from spatialalignmentnetwork_tpu.engine.checkpoint import ckpt_load as jckpt_load
from spatialalignmentnetwork_tpu.utils import visualize as jvis

from spatialalignmentnetwork_tpu_torch.data import convert as tconvert
from spatialalignmentnetwork_tpu_torch.data import loader as tloader
from spatialalignmentnetwork_tpu_torch.data import native_cache as tnative
from spatialalignmentnetwork_tpu_torch.data import nifti_minimal as tnifti
from spatialalignmentnetwork_tpu_torch.data import volumefolder as tvf
from spatialalignmentnetwork_tpu_torch.engine import checkpoint as tckpt
from spatialalignmentnetwork_tpu_torch.utils import visualize as tvis

from conftest import write_h5_volume

torch.set_num_threads(2)


class _Slices:
    """A map-style dataset of [target, aux] items of distinct values."""

    def __init__(self, n, size=6):
        rng = np.random.default_rng(n)
        self.items = [[rng.random((1, size, size)).astype(np.complex64) for _ in range(2)]
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _batches(loader):
    return [[np.array(x) for x in b] for b in loader]


# ------------------------------------------------------------ loader
@pytest.mark.parametrize("shards,seed,shuffle,drop_last", [
    (1, 0, True, True), (1, 7, True, True), (1, 0, False, False), (1, 3, True, False),
    (2, 0, True, True), (2, 7, True, True), (2, 0, False, True)])
def test_loader_batches_match_jax(shards, seed, shuffle, drop_last):
    """The same batches, in the same order, for a seed, each shard's rows
    of every global batch; over two epochs (the rng advances)."""
    data = _Slices(11)
    for index in range(shards):
        kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=seed,
                  num_shards=shards, shard_index=index)
        got_loader, want_loader = tloader.Loader(data, 2, **kw), jloader.Loader(data, 2, **kw)
        assert len(got_loader) == len(want_loader)
        for _ in range(2):
            got, want = _batches(got_loader), _batches(want_loader)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)


def test_loader_refuses_bad_shards():
    data = _Slices(4)
    with pytest.raises(ValueError, match="drop_last"):
        tloader.Loader(data, 2, num_shards=2, shard_index=0)
    with pytest.raises(ValueError, match="shard_index"):
        tloader.Loader(data, 2, drop_last=True, num_shards=2, shard_index=2)


def test_loader_relays_a_worker_error_and_releases_an_abandoned_producer():
    """A dataset error reaches the consumer; an iterator abandoned
    mid-epoch (the train loop's intel_stop break) lets its producer thread
    end, with its queue full."""

    class Broken(_Slices):
        def __getitem__(self, i):
            raise OSError("unreadable slice")

    with pytest.raises(OSError, match="unreadable slice"):
        list(tloader.Loader(Broken(4), 2, num_workers=2))
    before = threading.active_count()
    it = iter(tloader.Loader(_Slices(40), 1, num_workers=2, prefetch_batches=1))
    next(it)
    time.sleep(0.3)  # let the producer fill the queue and block on it
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_and_device_prefetch():
    data = _Slices(5)
    got, want = tloader.Prefetch(data, workers=3), jloader.Prefetch(data, workers=3)
    assert len(got) == len(want) == 5
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    batches = _batches(tloader.Loader(data, 2))
    staged = list(tloader.device_prefetch(iter(batches), "cpu", size=2))
    assert len(staged) == len(batches)
    for s, b in zip(staged, batches):
        for t, a in zip(s, b):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)


# ------------------------------------------------------------ native cache
@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two T1/T2 pairs (4 and 3 slices at 24x20) and their CSV."""
    root = tmp_path_factory.mktemp("host_volumes")
    rows = []
    for v, s in enumerate((4, 3)):
        for proto, seed in (("T1", 2 * v), ("T2", 2 * v + 1)):
            write_h5_volume(str(root / f"p{v}_{proto}.h5"), proto, shape=(s, 24, 20),
                            seed=seed, maxval=3.0)
        rows.append(f"p{v}_T1.h5,p{v}_T2.h5")
    (root / "pairs.csv").write_text("\n".join(rows) + "\n")
    return root, str(root / "pairs.csv")


def test_native_cache_matches_jax(volumes, tmp_path):
    """Cache files and slice counts byte-equal to the JAX package's, and
    batches (crop and pad) equal to the JAX cache's, from the port's own
    build of the library."""
    _, csv = volumes
    got = tnative.build_caches_from_csv(csv, ["T2", "T1", "None"], str(tmp_path / "port"))
    want = jnative.build_caches_from_csv(csv, ["T2", "T1", "None"], str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == ["cache_T2.bin", "cache_T1.bin"]
    for g, w in zip(got, want):
        for suffix in ("", ".counts.json"):
            with open(g + suffix, "rb") as a, open(w + suffix, "rb") as b:
                assert a.read() == b.read(), g + suffix
    assert os.path.dirname(tnative._load_lib()._name) == tnative.BUILD_DIR
    for crop in (16, 30):
        ds_t, ds_j = tnative.NativePairedSlices(got, crop), jnative.NativePairedSlices(want, crop)
        assert len(ds_t) == len(ds_j) == 7
        idx = np.array([6, 0, 3])
        for a, b in zip(ds_t.batch(idx), ds_j.batch(idx)):
            assert a.shape == (3, 1, crop, crop) and a.dtype == np.complex64
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ds_t[5], ds_j[5]):
            np.testing.assert_array_equal(a, b)
    batch = next(iter(tloader.Loader(tnative.NativePairedSlices(got, 16), 4, shuffle=True)))
    assert [x.shape for x in batch] == [(4, 1, 16, 16)] * 2
    with pytest.raises(IndexError):
        tnative.NativeSliceCache(got[0]).batch([7], 16)


def test_native_cache_refuses_mismatched_volumes(volumes, tmp_path):
    """A volume of another slice shape, and per-volume counts that differ
    between protocols, raise as in the JAX package."""
    root, _ = volumes
    write_h5_volume(str(tmp_path / "odd.h5"), "T1", shape=(2, 20, 20))
    with pytest.raises(ValueError, match="cache shape"):
        tnative.write_cache([str(root / "p0_T1.h5"), str(tmp_path / "odd.h5")],
                            str(tmp_path / "c.bin"))
    write_h5_volume(str(tmp_path / "a_T1.h5"), "T1", shape=(3, 8, 8))
    write_h5_volume(str(tmp_path / "a_T2.h5"), "T2", shape=(2, 8, 8))
    (tmp_path / "bad.csv").write_text("a_T1.h5,a_T2.h5\n")
    with pytest.raises(ValueError, match="slice counts differ"):
        tnative.build_caches_from_csv(str(tmp_path / "bad.csv"), ["T2", "T1"],
                                      str(tmp_path / "out"))


def test_native_cache_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output: no fall back."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        tnative._load_lib()
    assert os.listdir(tmp_path / "build") == []  # no half-written library left


# ------------------------------------------------------------ NIfTI, convert
AFFINES = {
    "ras": np.diag([0.7, 0.8, 5.0, 1.0]),
    "flipped": np.diag([-0.7, 0.8, -5.0, 1.0]),
    "permuted": np.array([[0, 0.8, 0, 1], [-0.7, 0, 0, 2], [0, 0, 5.0, 3], [0, 0, 0, 1.0]]),
}


@pytest.mark.parametrize("affine", sorted(AFFINES))
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_nifti_and_convert_match_jax(affine, ext, tmp_path):
    """write_nii writes the JAX package's bytes; read_nii, to_canonical and
    the converter's array agree exactly; both converters write h5 files of
    equal contents from one NIfTI."""
    vol = np.random.default_rng(1).random((9, 7, 5)).astype(np.float32) * 100
    got, want = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    tnifti.write_nii(got, vol, affine=AFFINES[affine])
    jnifti.write_nii(want, vol, affine=AFFINES[affine])
    if ext == ".nii":
        with open(got, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()
    data_t, aff_t = tnifti.read_nii(got)
    data_j, aff_j = jnifti.read_nii(want)
    np.testing.assert_array_equal(data_t, data_j)
    np.testing.assert_array_equal(aff_t, aff_j)
    np.testing.assert_array_equal(tnifti.to_canonical(data_t, aff_t),
                                  jnifti.to_canonical(data_j, aff_j))
    np.testing.assert_array_equal(tconvert.nii_to_array(got), jconvert.nii_to_array(want))
    import h5py

    tconvert.main([got, str(tmp_path / "port.h5"), "T1"])
    jconvert.main([want, str(tmp_path / "jax.h5"), "T1"])
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "jax.h5") as b:
        np.testing.assert_array_equal(a["image"][()], b["image"][()])
        assert dict(a.attrs) == dict(b.attrs)


def test_convert_batch_writes_the_manifest(tmp_path):
    """--batch converts per-modality directories into paired h5 volumes
    and a CSV that the paired datasets read; mismatched counts raise."""
    import h5py

    rng = np.random.default_rng(2)
    for proto in ("T1", "T2"):
        d = tmp_path / proto
        d.mkdir()
        for i in range(2):
            tnifti.write_nii(str(d / f"s{i}.nii"), rng.random((6, 5, 3)).astype(np.float32) + 0.1)
    out = tmp_path / "out"
    tconvert.main(["--batch", str(tmp_path / "T1"), str(tmp_path / "T2"),
                   "--protocals", "T1", "T2", "--out", str(out), "--manifest", "m.csv"])
    rows = (out / "m.csv").read_text().split()
    assert rows == ["v0000_T1.h5,v0000_T2.h5", "v0001_T1.h5,v0001_T2.h5"]
    with h5py.File(out / "v0001_T2.h5") as h5:
        assert h5["image"].shape == (3, 5, 6) and h5.attrs["acquisition"] == "T2"
    tnifti.write_nii(str(tmp_path / "T2" / "s2.nii"), np.ones((6, 5, 3), np.float32))
    with pytest.raises(ValueError, match="different volume counts"):
        tconvert.convert_batch([str(tmp_path / "T1"), str(tmp_path / "T2")], ["T1", "T2"],
                               str(out), "m.csv")
    with pytest.raises(ValueError, match="max"):
        tconvert.write_h5(np.zeros((2, 3, 3), np.float32), str(tmp_path / "z.h5"), "T1")


# ------------------------------------------------------------ volume folders
def _volume_folder(root, name, protocal, slices, seed, complex_pairs):
    d = root / name
    d.mkdir()
    (d / "description.json").write_text('{"acquisition": "%s"}' % protocal)
    rng = np.random.default_rng(seed)
    for s in range(slices):
        shape = (2, 20, 18) if complex_pairs else (20, 18)
        np.save(d / f"{s:03d}.npy", rng.random(shape).astype(np.float32))


def test_volumefolder_matches_jax(tmp_path, capsys):
    """Aligned knee pairs by folder adjacency (an unpaired and a
    short volume skipped), their slices, and the pair-QC MI per pair."""
    layout = [("a", "CORPD_FBK", 5, True), ("b", "CORPDFS_FBK", 5, True),
              ("c", "CORPD_FBK", 4, False), ("d", "CORPD_FBK", 4, False),
              ("e", "CORPDFS_FBK", 4, False), ("f", "CORPDFS_FBK", 3, False)]
    for i, (name, proto, slices, cplx) in enumerate(layout):
        _volume_folder(tmp_path, name, proto, slices, i, cplx)
    for kw in (dict(), dict(crop=16, q=0.2)):
        got = tvf.get_aligned_volumes(str(tmp_path), **kw)
        want = jvf.get_aligned_volumes(str(tmp_path), **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for i in range(len(w)):
                for a, b in zip(g[i], w[i]):
                    assert a.dtype == np.complex64
                    np.testing.assert_array_equal(a, b)
    got = tvf.main([str(tmp_path), str(tmp_path / "qc"), "--crop", "16"])
    assert got == jvf.pair_qc(str(tmp_path), crop=16)
    assert len(os.listdir(tmp_path / "qc")) == 9
    assert "0,5,a,b," in capsys.readouterr().out


# ------------------------------------------------------------ visualize
@pytest.mark.parametrize("n,c,nrow,value_range", [
    (16, 1, 4, (0, 1)), (5, 3, 2, (0, 1)), (3, 1, 4, (-1, 2))])
def test_make_grid_matches_jax(n, c, nrow, value_range, tmp_path):
    x = np.random.default_rng(n).normal(0.5, 0.6, (n, c, 12, 10)).astype(np.float32)
    got = tvis.make_grid(x, nrow=nrow, padding=3, value_range=value_range, pad_value=0.5)
    want = jvis.make_grid(x, nrow=nrow, padding=3, value_range=value_range, pad_value=0.5)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    tvis.save_image(x, str(tmp_path / "g.jpg"), nrow=nrow, padding=3, value_range=value_range)
    from PIL import Image

    assert Image.open(tmp_path / "g.jpg").size == (want.shape[1], want.shape[0])
    with pytest.raises(ValueError, match=r"\[N, 1\|3, H, W\]"):
        tvis.make_grid(x[:, :1, 0])


# ------------------------------------------------------------ re-pack CLI
def test_repack_cli_round_trip(tmp_path):
    """A reference single-file checkpoint re-packed in place (the file
    replaced by a native directory), and a directory copied to OUT by
    `python -m ...engine.checkpoint`: every array and the config as in the
    source, read by the JAX loader too."""
    rng = np.random.default_rng(4)
    sds = {"net_T": {"head.weight": torch.from_numpy(rng.random((2, 3)).astype(np.float32))},
           "net_mask": {"pruned": torch.from_numpy(rng.random(8) > 0.5)}}
    src = str(tmp_path / "ref.pt")
    torch.save({**sds, "config": {"shape": 16, "reg": "Rec"}}, src)
    tckpt.main([src])
    assert os.path.isdir(src)
    for loaded in (tckpt.ckpt_load(src), jckpt_load(src)):
        assert loaded["config"].to_dict() == {"shape": 16, "reg": "Rec"}
        for name, sd in sds.items():
            assert set(loaded[name]) == set(sd)
            for k, v in sd.items():
                np.testing.assert_array_equal(loaded[name][k], v.numpy())
    out = str(tmp_path / "copy")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "spatialalignmentnetwork_tpu_torch.engine.checkpoint", src, out],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    a, b = tckpt.ckpt_load(src), tckpt.ckpt_load(out)
    assert set(a) == set(b)
    for name in sds:
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k])
