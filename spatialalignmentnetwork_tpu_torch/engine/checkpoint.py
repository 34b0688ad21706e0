"""The JAX package's directory-per-checkpoint format, read and written.

A checkpoint is a DIRECTORY holding one flat npz file per network (named
after the network, e.g. `net_R`) plus a JSON `config`. Network entries map
'/'-joined pytree paths to arrays: `params/...` for parameters, `stats/...`
for BatchNorm running statistics, and `pruned` for the mask; with the
optimizer state, an `opt_state` entry. The port reads and writes this
layout; `engine/from_jax.py` maps the entries to and from `state_dict`s.
"""

import os
import shutil

import numpy as np

from .config import Config


def flatten_tree(tree, prefix="") -> dict:
    """Nested dict pytree -> {'a/b/c': np.ndarray}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict) -> dict:
    out = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return out


def ckpt_load(folder: str) -> dict:
    """Load a native checkpoint directory -> {'net_X': flat dict,
    'config': Config}. Entries that are not npz files are refused.

    Recovers from an interrupted write as the JAX package does: a missing
    target with a `.repack` sibling (a re-pack cut before its rename) gets
    that directory renamed into place; a missing target with an
    `.old-save` sibling (a `ckpt_save` cut between its two renames, when
    `.old-save` is the whole previous checkpoint) loads `.old-save`."""
    base = folder.rstrip("/")
    if not os.path.exists(folder):
        if os.path.isdir(base + ".repack"):
            os.replace(base + ".repack", folder)
        elif os.path.isdir(base + ".old-save"):
            folder = base + ".old-save"
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"not a checkpoint directory: {folder}")
    ckpt = {}
    for key in os.listdir(folder):
        path = os.path.join(folder, key)
        if key == "config":
            ckpt[key] = Config().load(path)
        else:
            with np.load(path, allow_pickle=False) as z:
                ckpt[key] = {k: z[k] for k in z.files}
    return ckpt


def ckpt_save(ckpt: dict, folder: str):
    """Write {'net_X': flat dict, ..., 'config': Config} as a checkpoint
    directory (the layout and the sequence of the JAX package's
    `ckpt_save`). The new checkpoint is written whole to `.tmp-save`
    beside the target; then the old one is renamed to `.old-save`, the new
    one renamed into place, and only then is `.old-save` removed. A save
    cut at any point leaves a whole checkpoint under the target name, or
    (between the two renames) under `.old-save`, which `ckpt_load` reads
    when the target is missing."""
    if os.path.exists(folder) and not os.path.isdir(folder):
        raise FileExistsError(f"{folder} exists and is not a directory")
    base = folder.rstrip("/")
    tmp, old = base + ".tmp-save", base + ".old-save"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for key, val in ckpt.items():
        path = os.path.join(tmp, key)
        if key == "config":
            val.save(path)
        else:
            with open(path, "wb") as f:
                np.savez(f, **{k: np.asarray(v) for k, v in val.items()})
    if os.path.exists(folder):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(folder, old)
    os.replace(tmp, folder)
    if os.path.exists(old):  # also one left by a save cut between the renames
        shutil.rmtree(old)
