"""Rematerialization (the counterpart of the JAX package's `nn.remat`
around net_R's cascade body and `jax.checkpoint` around net_T's and
net_G's training forwards).

`checkpoint(fn, *args)` runs `fn` under `torch.utils.checkpoint`
(non-reentrant): the forward keeps only fn's inputs, and the backward
recomputes fn's activations. The port's stateful modules update buffers
in a training forward (BatchNorm2d's running statistics, SpectralConv's
power iteration), which a recomputation would run a second time: the
statistics would take two momentum updates, and the power iteration
would advance again and give a sigma other than the forward's, so the
gradient would be wrong. flax has neither problem, its state updates
being functional. So the forward records what each stateful module
computed, in call order (`record`), and the recomputation replays it
(`recomputing`, `replay`) without writing any buffer.
"""

import contextlib
import threading

from torch.utils import checkpoint as torch_checkpoint


class _Tape:
    """What one checkpointed call's stateful modules computed, in order."""

    def __init__(self):
        self.values = []
        self.pos = 0
        self.replaying = False


# `.tape`: the tape of the checkpointed call that this thread runs now,
# read by modules anywhere in a net. Each context below is entered by the
# thread that runs the forward or the recomputation (on a card, the
# backward's, autograd's device thread), with the call's tape in its
# closure, so a thread sees only its own call
_LOCAL = threading.local()


def _active():
    return getattr(_LOCAL, "tape", None)


@contextlib.contextmanager
def _use(tape, replaying):
    previous, _LOCAL.tape = _active(), tape
    tape.replaying, tape.pos = replaying, 0
    try:
        yield
    finally:
        _LOCAL.tape = previous


def checkpoint(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    tape = _Tape()
    return torch_checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (_use(tape, False), _use(tape, True)))


def recomputing() -> bool:
    """Whether this forward is the backward's recomputation of a
    checkpointed call (a stateful module then writes no buffer)."""
    tape = _active()
    return tape is not None and tape.replaying


def record(value):
    """Keep `value`, a stateful module's update, for the recomputation of
    the checkpointed call running now (nothing outside one)."""
    tape = _active()
    if tape is not None and not tape.replaying:
        tape.values.append(value)


def replay():
    """In a recomputation, the next value that the forward recorded."""
    tape = _active()
    value = tape.values[tape.pos]
    tape.pos += 1
    return value
