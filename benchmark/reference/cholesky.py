"""Judges a Cholesky factor (perm, L) of A against A itself.

A factor is right when P A P^T = L L^T with L lower triangular and its
diagonal positive; that L is then the unique Cholesky factor of P A P^T.
The structure is checked exactly, and the product on random probes z
drawn from the seed: every stored entry of L takes part in L (L^T z), so
a wrong column shows.  The number compared is the probes' backward error

    max_z  ||L (L^T z) - P A P^T z||_inf / (||A||_inf ||z||_inf),

all in float64 from the CSC arrays, and inf where the structure is
wrong or a value is not finite.
"""

from __future__ import annotations

import numpy as np

from . import csc


def backward_error(A: tuple, perm: np.ndarray, L: tuple,
                   rng: np.random.Generator, probes: int = 2) -> float:
    n = A[1]
    perm = np.asarray(perm, np.int64)
    m_l, n_l, indptr, indices, data = L
    if (perm.shape != (n,) or m_l != n or n_l != n
            or not np.array_equal(np.sort(perm), np.arange(n))
            or not np.isfinite(data).all()):
        return float("inf")
    cols = csc.columns(indptr)
    if (indices < cols).any():
        return float("inf")                  # an entry above the diagonal
    diag = np.zeros(n)
    np.add.at(diag, cols[indices == cols], data[indices == cols])
    if (diag <= 0).any():
        return float("inf")
    nrm = csc.norm_inf(A)
    worst = 0.0
    for _ in range(probes):
        z = rng.uniform(-1.0, 1.0, n)
        llz = csc.matvec(L, csc.rmatvec(L, z))
        w = np.empty(n)
        w[perm] = z                          # (P A P^T z) = (A w)[perm]
        paz = csc.matvec(A, w)[perm]
        worst = max(worst, float(np.abs(llz - paz).max()
                                 / (nrm * np.abs(z).max())))
    return worst
