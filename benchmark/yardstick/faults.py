"""Faults planted under a cell's program, to show that its comparison
catches them.  Each wraps the program's callable and breaks what it
returns (a tuple of tensors with the batch first); its results stay on the
device they came from."""

from __future__ import annotations

from typing import Callable


def half_batch(program: Callable) -> Callable:
    """Half of the batch left out: the second half's results are copies of
    the first half's."""
    def run(*args, **kwargs):
        outs = [o.clone() for o in program(*args, **kwargs)]
        for o in outs:
            h = o.shape[0] // 2
            o[h:2 * h] = o[:h]
        return tuple(outs)
    return run


def altered(program: Callable, edit: Callable) -> Callable:
    """One answer altered where it is produced: ``edit`` changes the cloned
    outputs in place."""
    def run(*args, **kwargs):
        outs = tuple(o.clone() for o in program(*args, **kwargs))
        edit(*outs)
        return outs
    return run


def negate_first_descriptor(pts, valid, desc) -> None:
    desc[0, 0] = -desc[0, 0]

