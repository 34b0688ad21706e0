"""The PyTorch port's checkpoint directory (`engine/checkpoint.py`): a save
cut at any step leaves a whole checkpoint that `ckpt_load` finds, as the
JAX package's `ckpt_save` / `ckpt_load` promise.

A save is cut by making the k-th call to `os.replace` or `shutil.rmtree`
inside the module raise; a cut `rmtree` first deletes one file of its
directory, as a kill in the middle of it would.
"""

import os
import shutil

import numpy as np
import pytest

from spatialalignmentnetwork_tpu_torch.engine import checkpoint
from spatialalignmentnetwork_tpu_torch.engine.checkpoint import ckpt_load, ckpt_save
from spatialalignmentnetwork_tpu_torch.engine.config import Config


def _ckpt(tag: float) -> dict:
    return {
        "net_T": {"params/a": np.full((3, 2), tag, np.float32),
                  "stats/b": np.arange(4, dtype=np.float32) + tag},
        "net_R": {"params/c": np.full((5,), -tag, np.float32)},
        "config": Config(shape=16, lr=1e-4, reg="Rec", tag=tag),
    }


def _assert_is(got: dict, want: dict):
    assert set(got) == set(want)
    for name, entry in want.items():
        if name == "config":
            assert got[name].to_dict() == entry.to_dict()
            continue
        assert set(got[name]) == set(entry), name
        for k, v in entry.items():
            np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name} {k}")


class Cut(Exception):
    pass


def _cut_at(monkeypatch, k: int, calls: list):
    """Make the k-th call (from 0) to os.replace or shutil.rmtree raise."""
    replace, rmtree = os.replace, shutil.rmtree

    def step(name, fn, path, *args):
        calls.append((name, os.path.basename(path)))
        if len(calls) - 1 == k:
            if name == "rmtree":  # a kill in the middle of the deletion
                os.remove(os.path.join(path, sorted(os.listdir(path))[0]))
            raise Cut(f"cut at {name}({path})")
        return fn(path, *args)

    monkeypatch.setattr(checkpoint.os, "replace",
                        lambda src, dst: step("replace", replace, src, dst))
    monkeypatch.setattr(checkpoint.shutil, "rmtree",
                        lambda path: step("rmtree", rmtree, path))


@pytest.mark.parametrize("stale_old", [False, True])
@pytest.mark.parametrize("k", range(4))
def test_a_cut_save_leaves_a_whole_checkpoint(tmp_path, monkeypatch, k, stale_old):
    """Save A, then save B over it cut at its k-th rename or removal (with
    or without a stale `.old-save` from an earlier cut save): the target
    name loads as A or B, whole, and a later save of B goes through."""
    target = str(tmp_path / "ckpt")
    a, b = _ckpt(1.0), _ckpt(2.0)
    ckpt_save(a, target)
    if stale_old:
        os.makedirs(target + ".old-save")
        open(os.path.join(target + ".old-save", "net_T"), "wb").close()
    calls = []
    with monkeypatch.context() as m:
        _cut_at(m, k, calls)
        try:
            ckpt_save(b, target)
            cut = False
        except Cut:
            cut = True
    assert cut == (k < len(calls)), calls
    got = ckpt_load(target)
    if not cut:
        _assert_is(got, b)
    else:
        try:
            _assert_is(got, a)
        except AssertionError:
            _assert_is(got, b)
    ckpt_save(b, target)
    _assert_is(ckpt_load(target), b)
    assert not os.path.exists(target + ".old-save")
    assert not os.path.exists(target + ".tmp-save")


def test_load_finishes_an_interrupted_repack(tmp_path):
    """A missing target beside a whole `.repack` directory is renamed into
    place and loaded (the JAX ckpt_load's recovery, checkpoint.py:107-111)."""
    target = str(tmp_path / "ckpt")
    a = _ckpt(3.0)
    ckpt_save(a, target)
    os.replace(target, target + ".repack")
    _assert_is(ckpt_load(target), a)
    assert os.path.isdir(target) and not os.path.exists(target + ".repack")
    with pytest.raises(FileNotFoundError):
        ckpt_load(str(tmp_path / "missing"))
