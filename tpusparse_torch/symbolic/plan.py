"""Symbolic factorization planners: schol (Cholesky) and sqr (QR/LU).

Reference (SURVEY.md §2.2): csparse::cs_schol / cs_schol.c and
csparse::cs_sqr / cs_sqr.c (with static cs_vcount).  These produce the
reference's ``css`` symbolic object — on the TPU side this object is the
root of the static device schedule (SURVEY.md §7.0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import cumsum, permute, symperm
from ..core.perm import pinv as _pinv
from .amd import amd
from .etree import counts, etree, post

__all__ = ["Symbolic", "schol", "sqr"]

_IDX = np.int64


@dataclass
class Symbolic:
    """The reference's css struct (SURVEY.md §2.1)."""
    pinv: Optional[np.ndarray] = None   # inverse row perm (Chol fill / QR rows)
    q: Optional[np.ndarray] = None      # column permutation (LU/QR)
    parent: Optional[np.ndarray] = None # elimination tree
    cp: Optional[np.ndarray] = None     # L column pointers (Chol) / R counts (QR)
    leftmost: Optional[np.ndarray] = None  # QR: leftmost col per row
    m2: int = 0                          # QR: rows incl. fictitious
    lnz: int = 0                         # predicted nnz(L) / nnz(V)
    unz: int = 0                         # predicted nnz(U) / nnz(R)


def schol(order: int, A: CSCMatrix) -> Symbolic:
    """Symbolic Cholesky: ordering, etree, postorder, column counts,
    column pointers of L (reference: csparse::cs_schol — call stack in
    SURVEY.md §3.1)."""
    n = A.n
    S = Symbolic()
    p = amd(order, A)
    S.pinv = _pinv(p) if p is not None else None
    C = symperm(A, S.pinv, values=False)
    S.parent = etree(C, ata=False)
    porder = post(S.parent)
    c = counts(C, S.parent, porder, ata=False)
    S.cp, S.lnz = cumsum(c)
    S.unz = S.lnz
    return S


def _vcount(A: CSCMatrix, S: Symbolic) -> None:
    """Compute the QR row permutation S.pinv, S.leftmost, S.m2, and
    nnz(V) = S.lnz (reference: static cs_vcount in cs_sqr.c — the row
    queue/bucket algorithm over the column etree)."""
    m, n = A.m, A.n
    Ap, Ai = A.indptr, A.indices
    parent = S.parent
    pinv = np.full(m + n, -1, dtype=_IDX)
    leftmost = np.full(m, -1, dtype=_IDX)
    nxt = np.full(m, -1, dtype=_IDX)
    head = np.full(n, -1, dtype=_IDX)
    tail = np.full(n, -1, dtype=_IDX)
    nque = np.zeros(n, dtype=_IDX)
    for k in range(n - 1, -1, -1):
        leftmost[Ai[Ap[k]:Ap[k + 1]]] = k       # min col index of each row
    for i in range(m - 1, -1, -1):              # scan rows in reverse
        k = leftmost[i]
        if k == -1:
            continue                            # row i is empty
        if nque[k] == 0:
            tail[k] = i                         # first row in queue k
        nque[k] += 1
        nxt[i] = head[k]                        # put i at head of queue k
        head[k] = i
    S.lnz = 0
    S.m2 = m
    for k in range(n):                          # row perm and nnz(V)
        i = head[k]                             # remove row i from queue k
        S.lnz += 1                              # count V(k,k)
        if i < 0:
            i = S.m2                            # add a fictitious row
            S.m2 += 1
        pinv[i] = k                             # row i becomes row k of V
        nque[k] -= 1
        if nque[k] <= 0:
            continue                            # V(k+1:m, k) is empty
        S.lnz += nque[k]                        # nnz of V(k+1:m, k)
        pa = parent[k]
        if pa != -1:                            # move queue k to parent
            if nque[pa] == 0:
                tail[pa] = tail[k]
            nxt[tail[k]] = head[pa]
            head[pa] = nxt[i]
            nque[pa] += nque[k]
    k = n
    for i in range(m):                          # order remaining rows last
        if pinv[i] < 0:
            pinv[i] = k
            k += 1
    S.pinv = pinv[:S.m2] if S.m2 > m else pinv[:m]
    S.leftmost = leftmost


def sqr(order: int, A: CSCMatrix, qr: bool) -> Symbolic:
    """Symbolic QR or LU analysis (reference: csparse::cs_sqr — call
    stacks in SURVEY.md §3.2/§3.3).

    qr=True: column etree of (AQ)'(AQ), postorder, R column counts, and
    vcount (row order, leftmost, m2, nnz V).  qr=False (LU): only the
    column ordering plus the reference's nnz guess lnz=unz=4*nnz(A)+n.
    """
    n = A.n
    S = Symbolic()
    S.q = amd(order, A)
    if qr:
        C = permute(A, None, S.q, values=False) if order else A.pattern()
        S.parent = etree(C, ata=True)
        porder = post(S.parent)
        S.cp = counts(C, S.parent, porder, ata=True)
        S.unz = int(S.cp.sum())                 # nnz(R)
        _vcount(C, S)
    else:
        S.unz = 4 * A.nnz + n                   # LU: loose preallocation guess
        S.lnz = S.unz
    return S
