"""The byte and operation counts of one f32 solve sweep of k right-hand
sides over a superscan Cholesky factor, for ``many_sweep_roofline``,
against the peaks of ``_roofline``.

A sweep runs forward (L y = b) and backward (L^T x = y).  Each direction
reads the factor's ``lnz`` entries once and reads and writes the (n, k)
block once, in float32: 4 lnz + 2 * 4 n k bytes; and does a multiply
and an add per factor entry and column: 2 lnz k operations.  So a sweep
is 2 (4 lnz + 8 n k) bytes and 4 lnz k operations.  The counts come
from the plan (``lnz``, n) and k, which the op states as facts of the
trace, and not from launch shapes, so any implementation of the sweep
reads the same work.
"""

from __future__ import annotations

from typing import Optional

from benchmark.metrics import _program, _roofline
from benchmark.metrics._roofline import F32

ROOT = "superscan.solve_many"
SWEEP = "superscan.solve.sweep"


def sweep_counts(lnz: int, n: int, k: int) -> tuple:
    """(bytes, operations) of one sweep, both directions."""
    return 2 * F32 * (lnz + 2 * n * k), 4 * lnz * k


def share(tr) -> Optional[float]:
    """Sum of each traced sweep's bound over the device time of the
    events that start inside the sweeps' spans, in %."""
    sweeps = _program.spans(tr, SWEEP, root=ROOT)
    facts = tr.facts
    if not sweeps or not all(f in facts for f in ("lnz", "n", "k")):
        return None
    busy = sum(e - s for _, s, e in tr.events
               if any(sw.start <= s < sw.end for sw in sweeps)) / 1e9
    if not busy:
        return None
    bound = _roofline.bound_s(*sweep_counts(facts["lnz"], facts["n"],
                                            facts["k"]))
    return 100.0 * len(sweeps) * bound / busy
