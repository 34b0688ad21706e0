"""A toy copy of a cell, small enough for the CPU: the cell's files with
every width and size cut, so that a test drives the whole run there."""

import copy

from harness.registry import Registry

TOY_MODEL = {
    "shape": 32, "net_T_layers": [4, 8, 8, 8, 8], "net_R_cascades": 2, "net_R_sens_chans": 2,
    "net_R_sens_pools": 2, "net_R_chans": 4, "net_R_pools": 2, "net_G_layers": [4, 8, 8, 8, 8],
    "net_D_blocks": [[4], [8], [8], [8], [8]],
}
TOY_TRAFFIC = {"serve_closed": {"batch": 4, "pool": 2, "warmup": 1, "keep_every": 1, "max_kept": 4},
               "train_step": {"batch": 4, "aug": 36, "pool_batches": 3, "warmup": 0}}


def toy_cell(name: str, config=None, registry=None) -> dict:
    """The cell `name` cut to toy sizes; with `config`, run under that
    configuration instead of its own."""
    registry = registry or Registry()
    cell = copy.deepcopy(registry.cell(name))
    if config is not None:
        cell["config"] = registry.load("configs", config)
    cell["config"]["model"].update(TOY_MODEL)
    cell["traffic"].update(TOY_TRAFFIC[cell["traffic"]["loop"]])
    return cell
