"""The model's repeated loops, in one place: the port's counterpart of the
reference's ``jax.lax.scan`` over stacked layers and over
``attend_full``'s query and key chunks.

``scan(body, carry, n)`` runs ``carry, y = body(carry, i)`` for i in
range(n) and returns the last carry and the list of the n ys.  Every loop
whose iterations repeat one computation goes through it: the layers of a
segment (full pass, block step, the SSM and RG-LRU steps) and the blockwise
attention's chunk pairs.  So an analysis that runs one iteration and
scales what it counts by the trip count, as the reference's HLO analysis
counts a scanned body once times its trip count, has this one seam to
wrap: ``runner(fn)`` makes ``fn(body, carry, n)`` stand in for the loop
inside a with block (``launch.step_analysis`` does).  Otherwise the loop
runs as written.
"""
from __future__ import annotations

import contextlib

_RUNNER = None


def scan(body, carry, n: int):
    """(carry, [y_0, ..., y_{n-1}]) of ``carry, y_i = body(carry, i)``."""
    if _RUNNER is not None:
        return _RUNNER(body, carry, n)
    ys = []
    for i in range(n):
        carry, y = body(carry, i)
        ys.append(y)
    return carry, ys


@contextlib.contextmanager
def runner(fn):
    """``fn(body, carry, n)`` runs every ``scan`` inside the with block."""
    global _RUNNER
    prev, _RUNNER = _RUNNER, fn
    try:
        yield
    finally:
        _RUNNER = prev
