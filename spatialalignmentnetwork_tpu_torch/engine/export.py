"""Ahead-of-time export of the serving path (the counterpart of the JAX
package's `engine/export.py`).

`export_reconstruct` traces the live `CSModel.recon_step` with
`torch.export` for one batch shape and serializes the program, with the
weights and the mask's `pruned` inside it: the artifact replays without
the model's Python code. The grid sample is the custom op
`san::grid_sample_fwd` (`kernels/grid_sample.py`), one node of the graph,
and in true f32 on the card each ConvBlock conv of net_R is the custom op
`san::conv3x3` (`kernels/conv.py`, routed by `models/layers.py::Conv3x3`),
so a program exported on the card launches the same CUDA kernels when it
replays there; the rest are aten operations.

Usage:
    from spatialalignmentnetwork_tpu_torch.engine.export import (
        export_reconstruct, load_exported,
    )
    export_reconstruct(net, batch_shape=(8, 1, 320, 320), path="recon.pt2")
    fn = load_exported("recon.pt2")
    rec = fn(img_full, img_aux)  # complex64 tensors on the model's device
"""

import io

import torch
from torch import nn

from ..kernels import conv, grid_sample  # noqa: F401 (register san::conv3x3, san::grid_sample_fwd)


class _ReconStep(nn.Module):
    """`net.recon_step` as a module whose submodules are the model's nets,
    so that their weights enter the program as its parameters and
    buffers. The exported computation is the live serving step: one
    source of truth."""

    def __init__(self, net):
        super().__init__()
        self.net_T = net.net_T
        self.net_R = net.net_R
        self._net = net

    def forward(self, img_full, img_aux):
        return self._net.recon_step(img_full, img_aux)


def export_reconstruct(net, batch_shape, path=None) -> bytes:
    """Serialize the eval-mode recon path for `batch_shape` (N, C, H, W),
    traced for complex64 inputs on the model's device.

    The weights, the BatchNorm statistics and `pruned` travel inside the
    artifact. A distributed model exports its one-device computation, as
    the JAX package's jit of `recon_step` does. Returns the serialized
    bytes (also written to `path` when given)."""
    net._nets_mode(train=False)
    spec = torch.empty(tuple(batch_shape), dtype=torch.complex64, device=net.device)
    with torch.inference_mode(False), torch.no_grad():
        program = torch.export.export(_ReconStep(net), (spec, spec.clone()), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes):
    """Deserialize an exported recon artifact -> callable(img_full,
    img_aux) on complex64 tensors of the exported shape, on the device it
    was exported on."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = io.BytesIO(bytes(path_or_bytes))
    else:
        src = path_or_bytes
    module = torch.export.load(src).module()
    return module.requires_grad_(False)  # a served call records no graph
