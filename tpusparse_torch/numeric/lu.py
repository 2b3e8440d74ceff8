"""Left-looking sparse LU with threshold partial pivoting (host f64).

Reference (SURVEY.md §2.2, §3.2): csparse::cs_lu / cs_lu.c.  Per column k:
spsolve against the partial L gives x = L \\ A(:, q[k]) with its pattern;
the pivot is the largest |x_i| among not-yet-pivotal rows, but the
diagonal entry is preferred when |x_diag| >= tol * max (threshold partial
pivoting, tol in (0, 1]).  L/U storage grows geometrically like the
reference's cs_sprealloc.

The data-dependent pivoting makes this inherently sequential — it stays
on host; the TPU path (tpusparse.device.lu_tpu) uses BTF blocking +
within-panel pivoting per BASELINE.json's north star.
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import CSCMatrix
from ..symbolic.plan import Symbolic
from .chol import Numeric
from .trisolve import spsolve

__all__ = ["lu"]

_IDX = np.int64


class _Growable:
    """Geometrically growing (indices, values) entry store — the
    vectorized analog of the reference's cs_sprealloc elbow room."""

    def __init__(self, cap: int):
        self.i = np.zeros(max(cap, 16), dtype=_IDX)
        self.x = np.zeros(max(cap, 16), dtype=np.float64)
        self.nz = 0

    def reserve(self, extra: int) -> None:
        need = self.nz + extra
        if need > self.i.size:
            cap = max(2 * self.i.size + extra, need)
            self.i = np.resize(self.i, cap)
            self.x = np.resize(self.x, cap)

    def push(self, i: int, x: float) -> None:
        self.i[self.nz] = i
        self.x[self.nz] = x
        self.nz += 1


def lu(A: CSCMatrix, S: Symbolic, tol: float = 1.0):
    """Factor P A Q = L U.  Returns Numeric(L, U, pinv) or None on
    structural/numerical singularity (zero pivot column), matching the
    reference's silent-failure contract."""
    n = A.n
    q = S.q
    Lbuf = _Growable(int(S.lnz))
    Ubuf = _Growable(int(S.unz))
    Lp = np.zeros(n + 1, dtype=_IDX)
    Up = np.zeros(n + 1, dtype=_IDX)
    pinv = np.full(n, -1, dtype=_IDX)
    for k in range(n):
        Lp[k] = Lbuf.nz
        Up[k] = Ubuf.nz
        Lbuf.reserve(n)
        Ubuf.reserve(n)
        col = int(q[k]) if q is not None else k
        # x = L \ A(:, col) on the current partial factor
        Lpart = CSCMatrix(n, n, Lp[:k + 1].tolist() + [Lbuf.nz] * (n - k),
                          Lbuf.i[:Lbuf.nz], Lbuf.x[:Lbuf.nz])
        xs, x = spsolve(Lpart, A, col, pinv=pinv, lo=True)
        # find the pivot
        ipiv = -1
        a = -1.0
        for i in xs:
            if pinv[i] < 0:                     # row i not yet pivotal
                t = abs(x[i])
                if t > a:
                    a = t
                    ipiv = int(i)
            else:                               # entry of U(:, k)
                Ubuf.push(pinv[i], x[i])
        if ipiv == -1 or a <= 0:
            return None                         # matrix is singular
        if pinv[col] < 0 and abs(x[col]) >= a * tol:
            ipiv = col                          # prefer the diagonal entry
        pivot = x[ipiv]
        Ubuf.push(k, pivot)                     # U(k,k) is last in U(:,k)
        pinv[ipiv] = k                          # ipiv is the kth pivot row
        Lbuf.push(ipiv, 1.0)                    # L(k,k) = 1, stored first
        for i in xs:
            if pinv[i] < 0:                     # entry of L(:, k)
                Lbuf.push(int(i), x[i] / pivot)
    Lp[n] = Lbuf.nz
    Up[n] = Ubuf.nz
    Li = pinv[Lbuf.i[:Lbuf.nz]]                 # map rows to pivotal order
    L = CSCMatrix(n, n, Lp, Li, Lbuf.x[:Lbuf.nz].copy())
    U = CSCMatrix(n, n, Up, Ubuf.i[:Ubuf.nz].copy(),
                  Ubuf.x[:Ubuf.nz].copy())
    return Numeric(L=L, U=U, pinv=pinv)
