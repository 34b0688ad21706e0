"""Faults planted in the program under a run, for the tests that must see
`correct` come out false and for the upper readings of `calibrate.py`.
Each takes the CSModel and breaks its timed path in place.
"""

import torch


def unchanged(model):
    """A step that returns its state unchanged."""
    model.update = lambda *args, **kwargs: None


def half_batch(model):
    """Half of the batch left out, the mean taken over the rest: the step
    sees only the first half of each batch."""
    set_input = model.set_input

    def first_half(full, aux=None):
        n = full.shape[0] // 2
        return set_input(full[:n], None if aux is None else aux[:n])

    model.set_input = first_half


def altered(model):
    """An answer altered where it is produced: every reconstruction scaled
    by 1.1."""
    reconstruct = model.reconstruct

    def scaled(full, aux=None):
        return reconstruct(full, aux) * 1.1

    model.reconstruct = scaled


def wrong_slot(model):
    """A wrong slot in every request: the last slice answered with the
    first slice's reconstruction."""
    reconstruct = model.reconstruct

    def swapped(full, aux=None):
        out = reconstruct(full, aux)
        return torch.cat([out[:-1], out[:1]])

    model.reconstruct = swapped


def half_served(model):
    """Half of the batch left out: the first half reconstructed and its
    answers returned for the second half too."""
    reconstruct = model.reconstruct

    def halved(full, aux=None):
        n = full.shape[0] // 2
        out = reconstruct(full[:n], None if aux is None else aux[:n])
        return torch.cat([out, out])

    model.reconstruct = halved


FAULTS = {"serve": {"altered": altered, "half_batch": half_served, "wrong_slot": wrong_slot},
          "train": {"unchanged": unchanged, "half_batch": half_batch}}
