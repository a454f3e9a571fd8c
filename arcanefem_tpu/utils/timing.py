"""The one timing idiom, shared by bench.py, chip_smoke.py and tools/.

JAX dispatch returns before the device finishes, so every timed call ends
in ``jax.block_until_ready``.  The first call (compile + first run) is
timed apart; the steady figure is the best of ``reps`` independent calls
on the same inputs, which is how a solve loop or a benchmark repeat
invokes the work.
"""

from __future__ import annotations

import time

import jax


def timed(fn, *args):
    """(result, seconds) of one call of ``fn(*args)`` run to completion."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def time_call(fn, *args, reps: int = 3):
    """(result, first_s, best_s): the first call's wall time (compile
    included on a cold cache) and the best of ``reps`` further calls."""
    out, first = timed(fn, *args)
    best = float("inf")
    for _ in range(reps):
        out, t = timed(fn, *args)
        best = min(best, t)
    return out, first, best
