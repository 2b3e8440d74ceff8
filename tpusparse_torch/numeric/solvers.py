"""One-call solver drivers: cholsol, lusol, qrsol (host f64 engine).

Reference (SURVEY.md §2.2, §3): csparse::cs_cholsol / cs_cholsol.c,
cs_lusol / cs_lusol.c, cs_qrsol / cs_qrsol.c.  Contract (SURVEY.md
Appendix A): each returns (ok, x); the parity layer in tpusparse.api
additionally overwrites b in place like the reference.  Failures are
silent-but-flagged (ok=False), never exceptions.

The TPU drivers with the same signatures live in tpusparse.device.solvers.
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import transpose
from ..core.perm import ipvec, pvec
from ..symbolic.plan import schol, sqr
from .chol import chol
from .lu import lu
from .qr import happly, qr
from .trisolve import lsolve, ltsolve, usolve, utsolve

__all__ = ["cholsol", "lusol", "qrsol"]


def cholsol(order: int, A: CSCMatrix, b: np.ndarray):
    """Solve A x = b for SPD A via AMD(order) + Cholesky.
    Returns (ok, x).  Reference: csparse::cs_cholsol (stack: SURVEY.md §3.1)."""
    if A.m != A.n or A.m != len(b):
        return False, None
    S = schol(order, A)
    N = chol(A, S)
    if N is None:
        return False, None                      # not positive definite
    x = ipvec(S.pinv, np.asarray(b, dtype=np.float64))   # x = P b
    x = lsolve(N.L, x)
    x = ltsolve(N.L, x)
    x = pvec(S.pinv, x)                         # b = P' x
    return True, x


def lusol(order: int, A: CSCMatrix, b: np.ndarray, tol: float = 1.0):
    """Solve square A x = b via AMD(order) + LU with threshold partial
    pivoting.  Returns (ok, x).  Reference: csparse::cs_lusol (§3.2)."""
    if A.m != A.n or A.m != len(b):
        return False, None
    S = sqr(order, A, qr=False)
    N = lu(A, S, tol)
    if N is None:
        return False, None                      # singular
    x = ipvec(N.pinv, np.asarray(b, dtype=np.float64))   # apply pivot perm
    x = lsolve(N.L, x)
    x = usolve(N.U, x)
    if x is None:
        return False, None                      # zero pivot in U
    x = ipvec(S.q, x)                           # undo column perm
    return True, x


def qrsol(order: int, A: CSCMatrix, b: np.ndarray):
    """Least-squares (m >= n) or minimum-norm (m < n) solve via sparse
    Householder QR.  Returns (ok, x) with len(x) == n.
    Reference: csparse::cs_qrsol (§3.3)."""
    m, n = A.m, A.n
    b = np.asarray(b, dtype=np.float64)
    if len(b) != m:
        return False, None
    if m >= n:
        S = sqr(order, A, qr=True)
        N = qr(A, S)
        if N is None:
            return False, None
        x = np.zeros(S.m2, dtype=np.float64)
        x[:m] = b
        x[:] = ipvec(S.pinv, x)                 # x = P b (padded rows)
        for k in range(n):                      # apply Householder refl.
            happly(N.L, k, N.B[k], x)
        x = usolve(N.U, x)                      # x = R \ x
        if x is None:
            return False, None                  # rank-deficient R
        sol = ipvec(S.q, x[:n])                 # undo column perm
        return True, sol
    else:
        AT = transpose(A, values=True)          # underdetermined: factor A'
        S = sqr(order, AT, qr=True)
        N = qr(AT, S)
        if N is None:
            return False, None
        x = np.zeros(S.m2, dtype=np.float64)
        x[:m] = pvec(S.q, b)                    # x = b(q)
        xt = utsolve(N.U, x)                    # x(0:m-1) = R' \ x(0:m-1)
        if xt is None:
            return False, None                  # rank-deficient R
        for k in range(m - 1, -1, -1):          # apply reflections in reverse
            happly(N.L, k, N.B[k], xt)
        sol = pvec(S.pinv, xt)[:n]
        return True, sol
