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
    'config': Config}. Entries that are not npz files are refused."""
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
    directory (the layout of the JAX package's `ckpt_save`). The new
    directory is written beside the target and then swapped in, so an
    interrupted save leaves the old checkpoint whole."""
    if os.path.exists(folder) and not os.path.isdir(folder):
        raise FileExistsError(f"{folder} exists and is not a directory")
    tmp = folder.rstrip("/") + ".tmp-save"
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
        shutil.rmtree(folder)
    os.replace(tmp, folder)
