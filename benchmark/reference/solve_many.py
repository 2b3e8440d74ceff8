"""Judges a block X of A X = B column by column: each column's residual
grade as the configuration states it, ||A x_j - b_j||_inf / (||A||_1
||x_j||_inf + ||b_j||_inf), in float64 from the CSC arrays
(``reference.solve``).  A block is as good as its worst column, so a
column of small scale is held to its own grade and not to the block's
largest; inf where X is not finite or of the wrong shape."""

from __future__ import annotations

import numpy as np

from . import csc, solve


def grades(A: tuple, X: np.ndarray, B: np.ndarray,
           nrm1: float = None) -> np.ndarray:
    """Each column's grade."""
    X = np.asarray(X, np.float64)
    B = np.asarray(B, np.float64)
    if X.shape != B.shape or X.ndim != 2:
        return np.full(B.shape[-1] if B.ndim else 1, np.inf)
    nrm1 = csc.norm_1(A) if nrm1 is None else nrm1
    return np.array([solve.grade(A, X[:, j], B[:, j], nrm1)
                     for j in range(B.shape[1])])


def grade(A: tuple, X: np.ndarray, B: np.ndarray,
          nrm1: float = None) -> float:
    """The largest column grade of the block."""
    return float(grades(A, X, B, nrm1).max())
