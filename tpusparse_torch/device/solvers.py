"""Device one-call SPD solve with the (ok, x) contract of the host engine
(counterpart of ``cholsol`` in tpusparse/device/solvers.py).

Host symbolic planning -> f32 factorization on ``device`` -> device
solves -> host f64 iterative refinement.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.matrix import CSCMatrix

from .chol_tpu import TpuCholesky
from .superscan import SuperscanCholesky
from .supernodal import SupernodalCholesky

__all__ = ["cholsol"]

# "auto" picks superscan from this n up, supernodal below it, as the JAX
# package does
SUPERSCAN_MIN_N = 16384


def cholsol(order: int, A: CSCMatrix, b: np.ndarray, engine: str = None,
            device="cuda"):
    """SPD solve (reference: cs_cholsol).  Returns (ok, x): (False, None)
    on a shape mismatch or when the factorization fails.

    ``engine`` (default TPUSPARSE_CHOL_ENGINE, else "auto"): "superscan",
    "supernodal" or "tiled" (the fixed-tile ``TpuCholesky``); "auto" is
    superscan for n >= 16,384 and supernodal below it.  Any other name
    raises ValueError.  A planner or kernel error propagates; it is never
    turned into ok=False.  So the JAX package's chain, where a crashing
    engine falls back to the next (superscan, supernodal, tiled, then
    ok=False), is not ported: it would hide a defect.
    """
    if A.m != A.n or A.m != len(b):
        return False, None
    if engine is None:
        engine = os.environ.get("TPUSPARSE_CHOL_ENGINE", "auto")
    if engine == "auto":
        engine = "superscan" if A.n >= SUPERSCAN_MIN_N else "supernodal"
    if engine == "superscan":
        F = SuperscanCholesky(A, order=order if order else 1, device=device)
    elif engine == "supernodal":
        F = SupernodalCholesky(A, order=order if order else 1, device=device)
    elif engine == "tiled":
        F = TpuCholesky(A, order=order, device=device)
    else:
        raise ValueError(f"unknown cholsol engine {engine!r}")
    if not F.factor():
        return False, None
    return True, F.solve(np.asarray(b, np.float64))
