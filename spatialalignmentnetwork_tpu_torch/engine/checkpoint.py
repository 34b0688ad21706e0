"""The JAX package's directory-per-checkpoint format, read and written,
and the reference's own checkpoints, read.

A checkpoint is a DIRECTORY holding one flat npz file per network (named
after the network, e.g. `net_R`) plus a JSON `config`. Network entries map
'/'-joined pytree paths to arrays: `params/...` for parameters, `stats/...`
for BatchNorm running statistics, and `pruned` for the mask; with the
optimizer state, an `opt_state` entry. The port reads and writes this
layout; `engine/from_jax.py` maps the entries to and from `state_dict`s.

`ckpt_load` also reads every layout the JAX package's loader takes (its
checkpoint.py:94-154), the reference's saves (its basemodel.py:17-41):

  * a directory whose entries are torch-serialized state dicts (zip or
    legacy pickle format);
  * a directory of npz files holding raw state dicts (torch key names);
  * a single torch-serialized FILE holding {'net_X': state_dict, ...,
    'config': dict}.

Such an entry comes back as its state dict in numpy, under torch key
names (`is_reference_entry` tells it from a native entry); `CSModel`
loads it into the module by those names. Torch files are read with
`weights_only=True`: no code from a checkpoint runs.

The re-pack CLI rewrites a checkpoint of any layout as a native
directory (the JAX package's checkpoint.py:157-178):

    python -m spatialalignmentnetwork_tpu_torch.engine.checkpoint CKPT [OUT]

With OUT it writes the copy there; without, it rewrites CKPT in place (a
single file is replaced by the directory only once that is written
whole).
"""

import os
import shutil
import zipfile

import numpy as np
import torch

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


def is_reference_entry(flat: dict) -> bool:
    """Is this network entry a raw reference state dict (torch key names)
    rather than a native one ('params/...', 'stats/...', 'pruned')? A bare
    {'pruned'} entry reads the same either way and counts as native (the
    rule of the JAX package's torch_compat.py:250-260)."""
    return any(
        not (k.startswith("params/") or k.startswith("stats/") or k == "pruned")
        for k in flat
    )


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _state_dict_arrays(sd) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def _is_torch_zip(path: str) -> bool:
    """A torch.save file of the zip format (an `<archive>/data.pkl`
    member). np.load would take it for an npz and return its members'
    raw bytes."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/data.pkl") or n == "data.pkl" for n in z.namelist())


def _read_entry(path: str) -> dict:
    """One network entry: an npz file (native, or a reference state dict
    under torch names), else a torch-serialized state dict."""
    if _is_torch_zip(path):
        return _state_dict_arrays(_torch_load(path))
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except ValueError:  # a pickle: torch's legacy format
        return _state_dict_arrays(_torch_load(path))


def _load_file(path: str) -> dict:
    """A single torch-serialized checkpoint file (the reference's
    basemodel.py:18-19): {'net_X': state_dict, ..., 'config': dict}."""
    raw = _torch_load(path)
    ckpt = {}
    for key, val in raw.items():
        if key == "config":
            ckpt[key] = Config(**dict(val))
        else:
            ckpt[key] = _state_dict_arrays(val)
    return ckpt


def ckpt_load(folder: str) -> dict:
    """Load a checkpoint -> {'net_X': flat dict, 'config': Config}: a
    checkpoint directory (native entries, reference state dicts in npz or
    torch files) or a single torch file.

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
    if os.path.isfile(folder):
        return _load_file(folder)
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"not a checkpoint: {folder}")
    ckpt = {}
    for key in os.listdir(folder):
        path = os.path.join(folder, key)
        if key == "config":
            ckpt[key] = Config().load(path)
        else:
            ckpt[key] = _read_entry(path)
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


def repack(src: str, out: str = None):
    """Load checkpoint `src` (any layout `ckpt_load` reads) and write it as
    a native directory at `out`, or in place of `src`."""
    ckpt = ckpt_load(src)
    if out is not None:
        ckpt_save(ckpt, out)
    elif os.path.isdir(src):
        ckpt_save(ckpt, src)  # replaces the directory only once the new one is whole
    else:
        # a single torch file: the directory is written beside it first, the
        # file removed only after that; `ckpt_load` finds a `.repack` left by
        # a cut between the two
        ckpt_save(ckpt, src + ".repack")
        os.remove(src)
        os.replace(src + ".repack", src)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="re-pack a checkpoint as a native directory")
    p.add_argument("ckpt", help="checkpoint of any layout")
    p.add_argument("out", nargs="?", default=None, help="where to write (default: in place)")
    args = p.parse_args(argv)
    repack(args.ckpt, args.out)


if __name__ == "__main__":
    main()
