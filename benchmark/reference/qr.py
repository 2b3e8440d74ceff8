"""Judges a sparse QR factor's R, with its column order q, against A
itself.

R is right when A(:, q) = Q R for some orthogonal Q, that is when
R^T R = A_q^T A_q with R upper triangular and q a permutation; R is then
A_q's R up to the signs of its rows.  The structure is checked exactly:
q a permutation, R n x n and upper triangular, every value finite and
every diagonal entry nonzero.  Then the product on random probes z drawn
from the seed: every stored entry of R takes part in R^T (R z), so a
wrong entry shows.  The number compared is the probes' backward error

    max_z  ||R^T (R z) - A_q^T (A_q z)||_inf
           / (||A||_1 ||A||_inf ||z||_inf),

all in float64 from the CSC arrays (A^T A is never formed), and inf
where the structure is wrong or a value is not finite.
"""

from __future__ import annotations

import numpy as np

from . import csc


def backward_error(A: tuple, q: np.ndarray, R: tuple,
                   rng: np.random.Generator, probes: int = 2) -> float:
    n = A[1]
    q = np.asarray(q, np.int64)
    m_r, n_r, indptr, indices, data = R
    if (q.shape != (n,) or m_r != n or n_r != n
            or not np.array_equal(np.sort(q), np.arange(n))
            or not np.isfinite(data).all()):
        return float("inf")
    cols = csc.columns(indptr)
    if (indices > cols).any():
        return float("inf")                  # an entry below the diagonal
    diag = np.zeros(n)
    np.add.at(diag, cols[indices == cols], data[indices == cols])
    if (diag == 0).any():
        return float("inf")
    nrm = csc.norm_1(A) * csc.norm_inf(A)
    worst = 0.0
    for _ in range(probes):
        z = rng.uniform(-1.0, 1.0, n)
        rtrz = csc.rmatvec(R, csc.matvec(R, z))
        w = np.zeros(n)
        w[q] = z                             # A_q z = A w
        ataz = csc.rmatvec(A, csc.matvec(A, w))[q]
        worst = max(worst, float(np.abs(rtrz - ataz).max()
                                 / (nrm * np.abs(z).max())))
    return worst
