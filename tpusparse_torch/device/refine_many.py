"""Iterative refinement of (n, k) right-hand sides at once: the loop of
``solve_many`` in tpusparse/device/chol_tpu.py and supernodal.py, which
both engines of the port share.

Each sweep computes the f64 residuals R = B - A X column by column on
the host, stops when max|R| / (||A||_1 max|X| + max|B|) < 1e-14, and
else adds the f32 device solve of R to X.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import gaxpy, norm1

__all__ = ["refine_many"]


def refine_many(A: CSCMatrix, solve_f32_many: Callable[[np.ndarray],
                                                       np.ndarray],
                B: np.ndarray, iters: int = 3) -> np.ndarray:
    X = solve_f32_many(B)
    nrmA = norm1(A)
    for _ in range(iters):
        R = np.stack([B[:, j] - gaxpy(A, X[:, j], np.zeros(A.m))
                      for j in range(B.shape[1])], axis=1)
        denom = nrmA * np.abs(X).max() + np.abs(B).max()
        if denom == 0 or np.abs(R).max() / denom < 1e-14:
            break
        X = X + solve_f32_many(R)
    return X
