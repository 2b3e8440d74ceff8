"""Up-looking sparse Cholesky and rank-1 update/downdate (host f64).

Reference (SURVEY.md §2.2, §3.1): csparse::cs_chol / cs_chol.c and
csparse::cs_updown / cs_updown.c.  The supernodal MXU version lives in
tpusparse.device.chol_tpu; this host engine provides reference-grade
(~1e-15) residuals and is the oracle for the device path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import symperm
from ..symbolic.etree import ereach
from ..symbolic.plan import Symbolic

__all__ = ["Numeric", "chol", "updown"]

_IDX = np.int64


@dataclass
class Numeric:
    """The reference's csn struct (SURVEY.md §2.1): L/U factors, the LU
    pivoting row permutation, and the QR Householder coefficients (for QR,
    L holds V and U holds R)."""
    L: Optional[CSCMatrix] = None
    U: Optional[CSCMatrix] = None
    pinv: Optional[np.ndarray] = None
    B: Optional[np.ndarray] = None


def chol(A: CSCMatrix, S: Symbolic) -> Optional[Numeric]:
    """Numeric up-looking Cholesky L L' = C = P A P'.

    Per column k: ereach gives the pattern of row k of L; a sparse
    triangular solve against the already-computed columns fills it in;
    the diagonal is d = C(k,k) - sum L(k,i)^2.  Returns None if A is not
    positive definite (d <= 0 at some k) — the reference's failure
    contract (SURVEY.md §5 "failure detection").
    """
    n = A.n
    C = symperm(A, S.pinv, values=True) if S.pinv is not None else A
    Cp, Ci, Cx = C.indptr, C.indices, C.data
    cp = S.cp
    parent = S.parent
    from .. import native
    if native.available():
        out = native.chol_numeric(n, Cp, Ci, Cx, cp, parent)
        if out is None:
            return None                         # not positive definite
        Li_n, Lx_n = out
        return Numeric(L=CSCMatrix(n, n, cp.copy(), Li_n, Lx_n))
    Lp = cp.copy()                              # column pointers of L
    c = cp[:n].copy()                           # next free slot per column
    Li = np.zeros(int(cp[n]), dtype=_IDX)
    Lx = np.zeros(int(cp[n]), dtype=np.float64)
    x = np.zeros(n, dtype=np.float64)
    w = np.zeros(n, dtype=bool)                 # ereach marks
    s = np.zeros(n, dtype=_IDX)                 # ereach stack
    for k in range(n):
        # pattern of L(k, :) in topological order
        pat = ereach(C, k, parent, s, w)
        # x = full(triu(C(:,k)))
        seg = slice(Cp[k], Cp[k + 1])
        mask = Ci[seg] <= k
        x[Ci[seg][mask]] = Cx[seg][mask]
        d = x[k]
        x[k] = 0.0
        for i in pat:                           # sparse row solve
            lki = x[i] / Lx[Lp[i]]              # L(k,i) = x(i)/L(i,i)
            x[i] = 0.0
            lo, hi = Lp[i] + 1, c[i]
            x[Li[lo:hi]] -= Lx[lo:hi] * lki
            d -= lki * lki
            p = c[i]
            c[i] += 1
            Li[p] = k                           # store L(k,i) in column i
            Lx[p] = lki
        if d <= 0:
            return None                         # not positive definite
        p = c[k]
        c[k] += 1
        Li[p] = k                               # L(k,k) = sqrt(d)
        Lx[p] = np.sqrt(d)
    L = CSCMatrix(n, n, Lp, Li, Lx)
    return Numeric(L=L)


def updown(L: CSCMatrix, sigma: int, C: CSCMatrix, parent) -> bool:
    """Rank-1 update (sigma=+1) / downdate (sigma=-1) of a Cholesky
    factor: L L' <- L L' + sigma * w w' where w = C(:,0), IN PLACE along
    the etree path from min(find(w)) to the root.

    Reference: csparse::cs_updown / cs_updown.c — the alpha/beta/gamma
    Givens-like recurrences.  Returns False if the downdate destroys
    positive definiteness (reference returns 0).
    """
    Lp, Li, Lx = L.indptr, L.indices, L.data
    n = L.n
    Cp, Ci, Cx = C.indptr, C.indices, C.data
    if Cp[0] >= Cp[1]:
        return True                             # nothing to do
    w = np.zeros(n, dtype=np.float64)
    f = int(Ci[Cp[0]:Cp[1]].min())              # first affected column
    w[Ci[Cp[0]:Cp[1]]] = Cx[Cp[0]:Cp[1]]
    beta = 1.0
    beta2 = 1.0
    j = f
    while j != -1:                              # walk the etree path
        p = Lp[j]
        alpha = w[j] / Lx[p]                    # alpha = w(j)/L(j,j)
        beta2 = beta * beta + sigma * alpha * alpha
        if beta2 <= 0:
            break                               # not positive definite
        beta2 = np.sqrt(beta2)
        delta = (beta / beta2) if sigma > 0 else (beta2 / beta)
        gamma = sigma * alpha / (beta2 * beta)
        Lx[p] = delta * Lx[p] + (gamma * w[j] if sigma > 0 else 0.0)
        beta = beta2
        for p in range(Lp[j] + 1, Lp[j + 1]):
            w1 = w[Li[p]]
            w2 = w1 - alpha * Lx[p]
            w[Li[p]] = w2
            Lx[p] = delta * Lx[p] + gamma * (w1 if sigma > 0 else w2)
        j = parent[j]
    return bool(beta2 > 0)
