"""What the benchmark takes from the program under test, the port
(`spatialalignmentnetwork_tpu_torch`), all in one place: `CSModel` built
from a configuration and loaded with the benchmark's weights, the train
path's augmentation and crop, and the launch counter of its kernels.
"""

import math

import torch

# `data/augment.py`'s draw ranges (frozen at commit 3f2e19a): rotation
# U(+-0.005 * 2 pi), shift U(+-0.05), 9x9 control offsets U(+-1/50)
ROTATION = 2 * math.pi * 0.005
TRANSLATION = 0.05
CONTROL_POINTS = 9
CONTROL_SCALE = 50


def build_model(model_cfg: dict, state: dict, mask_seed: int, device):
    """A CSModel of the configuration's `model` block on `device`, its
    mask from `mask_seed`, its four nets loaded with `state`."""
    from spatialalignmentnetwork_tpu_torch.engine.config import Config
    from spatialalignmentnetwork_tpu_torch.engine.csmodel import CSModel

    model = CSModel(cfg=Config(**model_cfg), device=device, seed=mask_seed)
    for name, sd in state.items():
        getattr(model, name).load_state_dict(sd, strict=True)
    return model


def draw_pbspline(gen: torch.Generator, n: int, device) -> dict:
    """The benchmark's draws of one PBSpline deformation for n samples."""
    def uniform(shape, half):
        return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * half

    return {"r": uniform((n,), ROTATION), "t": uniform((n,), TRANSLATION),
            "ctrl": uniform((n, 2, CONTROL_POINTS, CONTROL_POINTS), 1.0 / CONTROL_SCALE)}


def augment_and_crop(full, aux, draws, size):
    """The train path's input pipeline: the program's PBSpline
    augmentation of the pair from `draws`, then its center crop."""
    from spatialalignmentnetwork_tpu_torch.data.augment import augment_batch
    from spatialalignmentnetwork_tpu_torch.ops.crop import center_crop

    out = augment_batch("PBSpline", [full, aux], draws)
    return [center_crop(x, (size, size)) for x in out]


def launches() -> dict:
    """The port's kernel launch counts so far."""
    from spatialalignmentnetwork_tpu_torch import kernels

    return dict(kernels.LAUNCHES)


def reset_launches():
    from spatialalignmentnetwork_tpu_torch import kernels

    kernels.reset_launches()
