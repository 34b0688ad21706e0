"""Synthetic head-like phantom pairs, made on the device from a generator.

A frozen copy of `chip_smoke.py::phantoms` at commit 3f2e19a, drawn in
bulk on the device instead of one sample at a time on the host: each pair
is a target (T2-like) and a reference modality (T1-like) of 12 ellipses
painted in order, the first a large head outline, the reference's
geometry shifted by N(0, 0.03^2), both under one smooth linear phase.
"""

import math

import torch

ELLIPSES = 12


def phantoms(gen: torch.Generator, n: int, size: int, device):
    """(full, aux): complex64 [n, 1, size, size] each."""
    lin = torch.linspace(-1.0, 1.0, size, device=device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    shift = torch.randn((n, 2), generator=gen, device=device) * 0.03
    u = torch.rand((n, ELLIPSES, 7), generator=gen, device=device)
    head = torch.arange(ELLIPSES, device=device)[None, :, None] == 0  # the outline
    centre = (u[..., 0:2] - 0.5) * torch.where(head, 0.3, 1.0)
    axes = (0.1 + 0.3 * u[..., 2:4]) * torch.where(head, 2.2, 1.0)
    theta = math.pi * u[..., 4]
    values = 0.2 + 0.8 * u[..., 5:7]  # target, reference
    t2 = torch.zeros((n, size, size), device=device)
    t1 = torch.zeros((n, size, size), device=device)
    cos, sin = torch.cos(theta), torch.sin(theta)
    for e in range(ELLIPSES):
        for img, d, k in ((t2, None, 0), (t1, shift, 1)):
            cx = centre[:, e, 0] + (0 if d is None else d[:, 0])
            cy = centre[:, e, 1] + (0 if d is None else d[:, 1])
            x = xx[None] - cx[:, None, None]
            y = yy[None] - cy[:, None, None]
            c, s = cos[:, e, None, None], sin[:, e, None, None]
            a = (x * c + y * s) / axes[:, e, 0, None, None]
            b = (-x * s + y * c) / axes[:, e, 1, None, None]
            img.copy_(torch.where(a * a + b * b <= 1, values[:, e, k, None, None], img))
    slope = torch.randn((n, 2), generator=gen, device=device)
    angle = math.pi * 0.3 * (xx[None] * slope[:, 0, None, None] + yy[None] * slope[:, 1, None, None])
    phase = torch.polar(torch.ones_like(angle), angle)
    return (t2 * phase)[:, None].contiguous(), (t1 * phase)[:, None].contiguous()
