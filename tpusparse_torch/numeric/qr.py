"""Sparse Householder QR (host f64).

Reference (SURVEY.md §2.2, §3.3): csparse::cs_qr / cs_qr.c,
cs_house / cs_house.c, cs_happly / cs_happly.c.  V (the Householder
vectors) is returned in Numeric.L, R in Numeric.U, and the beta
coefficients in Numeric.B — the reference's csn convention.

The blocked WY/MXU version lives in tpusparse.device.qr_tpu.
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import CSCMatrix
from ..symbolic.plan import Symbolic
from .chol import Numeric

__all__ = ["house", "happly", "qr"]

_IDX = np.int64


def house(x: np.ndarray):
    """Householder reflection for a dense vector: returns (v, beta, s)
    with H = I - beta v v' such that H x = s e1, sign of s chosen to
    avoid cancellation.

    Reference: csparse::cs_house / cs_house.c (same v scaling: the
    returned v is NOT normalized to v[0]=1; beta = -1/(s*v[0])).
    """
    v = np.array(x, dtype=np.float64, copy=True)
    sigma = float(v[1:] @ v[1:]) if v.size > 1 else 0.0
    if sigma == 0.0:
        s = abs(v[0])
        beta = 2.0 if v[0] <= 0 else 0.0
        v[0] = 1.0
    else:
        s = np.sqrt(v[0] * v[0] + sigma)
        v[0] = (v[0] - s) if v[0] <= 0 else (-sigma / (v[0] + s))
        beta = -1.0 / (s * v[0])
    return v, beta, s


def happly(V: CSCMatrix, i: int, beta: float, x: np.ndarray) -> np.ndarray:
    """Apply the ith Householder reflection H = I - beta*v*v' (v = column
    i of sparse V) to dense x, in place.  Reference: csparse::cs_happly."""
    lo, hi = V.indptr[i], V.indptr[i + 1]
    idx = V.indices[lo:hi]
    vv = V.data[lo:hi]
    tau = beta * float(vv @ x[idx])
    x[idx] -= vv * tau
    return x


def qr(A: CSCMatrix, S: Symbolic) -> Numeric:
    """Numeric sparse Householder QR of A (m >= n; rows padded to S.m2
    for rank detection).  Per column k: scatter the permuted column,
    apply prior reflections on the R(:,k) pattern (from leftmost/parent),
    then compute the new reflection.

    Reference: csparse::cs_qr / cs_qr.c (uses cs_scatter for child V
    pattern merging).
    """
    m, n = A.m, A.n
    Ap, Ai, Ax = A.indptr, A.indices, A.data
    q, parent, pinv = S.q, S.parent, S.pinv
    m2 = S.m2
    leftmost = S.leftmost
    vnz_cap = int(S.lnz)
    rnz_cap = int(S.unz) + n
    Vp = np.zeros(n + 1, dtype=_IDX)
    Vi = np.zeros(max(vnz_cap, 1), dtype=_IDX)
    Vx = np.zeros(max(vnz_cap, 1), dtype=np.float64)
    Rp = np.zeros(n + 1, dtype=_IDX)
    Ri = np.zeros(max(rnz_cap, 1), dtype=_IDX)
    Rx = np.zeros(max(rnz_cap, 1), dtype=np.float64)
    Beta = np.zeros(n, dtype=np.float64)
    x = np.zeros(m2, dtype=np.float64)
    w = np.full(m2, -1, dtype=_IDX)             # node marks
    s = np.zeros(n, dtype=_IDX)                 # R-pattern stack
    rnz = 0
    vnz = 0
    for k in range(n):
        if vnz + m2 + 1 > Vi.size:              # elbow room (cs_sprealloc)
            Vi = np.resize(Vi, 2 * Vi.size + m2)
            Vx = np.resize(Vx, Vi.size)
        if rnz + n + 1 > Ri.size:
            Ri = np.resize(Ri, 2 * Ri.size + n)
            Rx = np.resize(Rx, Ri.size)
        Rp[k] = rnz
        Vp[k] = p1 = vnz
        w[k] = k                                # V(k,k) is in the pattern
        Vi[vnz] = k
        vnz += 1
        top = n
        col = int(q[k]) if q is not None else k
        for p in range(Ap[col], Ap[col + 1]):   # find R(:,k) pattern
            i = leftmost[Ai[p]]
            length = 0
            while w[i] != k:                    # traverse up the etree
                s[length] = i
                length += 1
                w[i] = k
                i = parent[i]
            while length > 0:
                length -= 1
                top -= 1
                s[top] = s[length]              # push path on stack
            i = pinv[Ai[p]]                     # permuted row of A(:,col)
            x[i] = Ax[p]
            if i > k and w[i] < k:              # pattern of V(:,k)
                Vi[vnz] = i
                vnz += 1
                w[i] = k
        for pidx in range(top, n):              # each i in R(:,k) pattern
            i = s[pidx]
            # apply (V(:,i), Beta[i]) to x
            lo, hi = Vp[i], Vp[i + 1]
            idx = Vi[lo:hi]
            tau = Beta[i] * float(Vx[lo:hi] @ x[idx])
            x[idx] -= Vx[lo:hi] * tau
            Ri[rnz] = i                         # R(i,k) = x(i)
            Rx[rnz] = x[i]
            rnz += 1
            x[i] = 0.0
            if parent[i] == k:                  # merge child V pattern
                for pp in range(Vp[i], Vp[i + 1]):
                    ii = Vi[pp]
                    if w[ii] < k:
                        w[ii] = k
                        Vi[vnz] = ii
                        vnz += 1
        vseg = Vi[p1:vnz]
        vcol = x[vseg].copy()                   # gather V(:,k) = x
        x[vseg] = 0.0
        v, beta_k, snorm = house(vcol)
        Vx[p1:vnz] = v
        Beta[k] = beta_k
        Ri[rnz] = k                             # R(k,k) = +-norm(x)
        Rx[rnz] = snorm
        rnz += 1
    Rp[n] = rnz
    Vp[n] = vnz
    V = CSCMatrix(m2, n, Vp, Vi[:vnz].copy(), Vx[:vnz].copy())
    R = CSCMatrix(m2, n, Rp, Ri[:rnz].copy(), Rx[:rnz].copy())
    return Numeric(L=V, U=R, B=Beta, pinv=pinv)
