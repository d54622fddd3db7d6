"""Faults planted in the port under the timed path, for the checks that
``correct`` catches them.

Each driver names the faults that its cells can have (``FAULTS``) and
says where each is planted (``patches(fault)``: ``(module, attribute,
wrap)`` triples); :func:`planted` applies them while a cell's set-up and
window run. The kinds:

* ``unchanged``: a step returns its state unchanged;
* ``half_batch``: half of the batch left out;
* ``altered``: an answer altered where it is produced (:func:`bump`).

The exchange between chips does not apply: every cell so far runs on one
chip.
"""
from __future__ import annotations

import contextlib
from unittest import mock


def bump(x):
    """``x`` with +1 on every 64th entry."""
    x = x.clone()
    x[::64] += 1.0
    return x


@contextlib.contextmanager
def planted(driver: str, fault: str):
    """Patch the port with ``fault`` of driver ``driver``
    (``drivers/<driver>.py``)."""
    from benchmark.harness import manifest as M
    with contextlib.ExitStack() as stack:
        for target, name, wrap in M.driver(driver).patches(fault):
            stack.enter_context(mock.patch.object(target, name, wrap(getattr(target, name))))
        yield
