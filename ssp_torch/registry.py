"""Name → factory registry.

The port's copy of ``ssp/registry.py``: the same public names
(``SuperPointNet_gauss2``, ``SuperPointNet_gauss2_ssmall``), resolved
through an explicit table rather than reflection, so names stay
greppable and several names can alias one implementation.  Models and
datasets are registered so far; the ``agent`` kind comes with training.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRIES: Dict[str, Dict[str, Callable[..., Any]]] = {"model": {}, "dataset": {}}


def register(kind: str, *names: str) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn_or_cls`` under each of ``names``."""

    def deco(fn_or_cls: Callable) -> Callable:
        table = _REGISTRIES[kind]
        for name in names:
            if name in table:
                raise KeyError(f"duplicate {kind} registration: {name!r}")
            table[name] = fn_or_cls
        return fn_or_cls

    return deco


def get(kind: str, name: str) -> Callable[..., Any]:
    table = _REGISTRIES[kind]
    try:
        return table[name]
    except KeyError:
        known = ", ".join(sorted(table))
        raise KeyError(f"unknown {kind} {name!r}; known: {known}") from None
