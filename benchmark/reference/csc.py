"""Plain float64 products with a CSC matrix held as the tuple
(m, n, indptr, indices, data), the arrays the benchmark builds and hands
to the program."""

from __future__ import annotations

import numpy as np


def columns(indptr: np.ndarray) -> np.ndarray:
    """The column of every stored entry."""
    return np.repeat(np.arange(indptr.size - 1), np.diff(indptr))


def matvec(A: tuple, x: np.ndarray) -> np.ndarray:
    """A @ x for x (n,), in float64."""
    m, _, indptr, indices, data = A
    return np.bincount(indices,
                       weights=data * np.asarray(x, np.float64)[
                           columns(indptr)], minlength=m)


def rmatvec(A: tuple, x: np.ndarray) -> np.ndarray:
    """A^T @ x for x (m,), in float64."""
    _, n, indptr, indices, data = A
    return np.bincount(columns(indptr),
                       weights=data * np.asarray(x, np.float64)[indices],
                       minlength=n)


def norm_inf(A: tuple) -> float:
    """Largest row sum of |A|."""
    m, _, _, indices, data = A
    return float(np.bincount(indices, weights=np.abs(data),
                             minlength=m).max())


def norm_1(A: tuple) -> float:
    """Largest column sum of |A|."""
    _, n, indptr, _, data = A
    return float(np.bincount(columns(indptr), weights=np.abs(data),
                             minlength=n).max())
