"""Iterative refinement of (n, k) right-hand sides at once: the loop of
``solve_many`` in tpusparse/device/chol_tpu.py and supernodal.py, which
every engine of the port shares.

Each sweep computes the f64 residuals R = B - A X column by column on
the host and reads each column's own grade, ||r_j||_inf / (||A||_1
||x_j||_inf + ||b_j||_inf).  It stops when every column's grade is below
1e-14 (a zero column counts as met), and else adds the f32 device
solve of all of R to X, so the columns that have met it are swept too.
The test reads each column, where the JAX package's reads max|R| against
||A||_1 max|X| + max|B| over the block: there a column far smaller than
the largest stops with it, at whatever grade it has reached.  The
residuals of a sweep are computed in the span ``refine_many.residual``,
which a reader tells apart by the root span of its caller.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import gaxpy, norm1
from ..utils.profiling import span

__all__ = ["refine_many"]


def refine_many(A: CSCMatrix, solve_f32_many: Callable[[np.ndarray],
                                                       np.ndarray],
                B: np.ndarray, iters: int = 3) -> np.ndarray:
    X = solve_f32_many(B)
    nrmA = norm1(A)
    nrmB = np.abs(B).max(axis=0)
    for _ in range(iters):
        with span("refine_many.residual"):
            R = np.stack([B[:, j] - gaxpy(A, X[:, j], np.zeros(A.m))
                          for j in range(B.shape[1])], axis=1)
        denom = nrmA * np.abs(X).max(axis=0) + nrmB
        met = (np.abs(R).max(axis=0) < 1e-14 * denom) | (denom == 0)
        if met.all():
            break
        X = X + solve_f32_many(R)
    return X
