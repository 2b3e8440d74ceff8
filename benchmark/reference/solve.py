"""Judges a solution x of A x = b by the residual grade the configuration
states, ||A x - b||_inf / (||A||_1 ||x||_inf + ||b||_inf), computed in
float64 from the CSC arrays; inf where x is not finite or of the wrong
shape."""

from __future__ import annotations

import numpy as np

from . import csc


def grade(A: tuple, x: np.ndarray, b: np.ndarray,
          nrm1: float = None) -> float:
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    if x.shape != b.shape or not np.isfinite(x).all():
        return float("inf")
    nrm1 = csc.norm_1(A) if nrm1 is None else nrm1
    r = csc.matvec(A, x) - b
    return float(np.abs(r).max()
                 / (nrm1 * np.abs(x).max() + np.abs(b).max()))
