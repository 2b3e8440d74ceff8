"""Host planner of the fixed-tile Cholesky engine.

A copy of tpusparse/device/chol_tpu.py:72-199 (``_tile_pattern``,
``CholPlan``, ``plan_cholesky``) apart from the import lines: that
module imports jax at load time, and this package must not.
``_scalar_row_patterns`` comes from the port's ``patterns`` copy.
tests/test_torch_imports.py holds the text to the original's,
tests/test_torch_chol_tpu.py the plans bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import permute
from ..core.perm import pinv as _pinv
from ..symbolic.amd import amd
from .config import default_block, round_up
from .patterns import _scalar_row_patterns

__all__ = ["CholPlan", "plan_cholesky"]

_IDX = np.int64


def _tile_pattern(n: int, B: int, rowptr, entries):
    """EXACT tile pattern of L: tiles that contain at least one scalar
    fill entry.  (A block-quotient closure would over-approximate badly —
    updates whose destination tile holds no scalar fill are structurally
    zero, because a nonzero term l(i,k)*l(j,k) forces scalar fill at
    (i,j) by the no-cancellation fill theorem — so they are SKIPPED.)"""
    nb = round_up(n, B) // B
    tilepairs = set()
    for k in range(n):
        I = k // B
        tilepairs.add((I, I))                   # diagonal (incl. L(k,k))
        for j in entries[rowptr[k]:rowptr[k + 1]]:
            tilepairs.add((I, int(j) // B))     # row k, col j < k
    colpat = [set() for _ in range(nb)]
    for I, J in tilepairs:
        colpat[J].add(I)
    return tilepairs, colpat


@dataclass
class CholPlan:
    """Static device schedule for one sparsity pattern."""
    n: int
    B: int
    nb: int
    perm: Optional[np.ndarray]          # fill-reducing permutation p
    pinv: Optional[np.ndarray]
    diag_id: np.ndarray                 # (nb,) pool slot of tile (k,k)
    off_ids: List[np.ndarray]           # per k: pool slots of L(I,k), I>k
    off_rows: List[np.ndarray]          # per k: tile-row I of each off slot
    upd_dst: List[np.ndarray]           # per k: dst pool slots
    upd_a: List[np.ndarray]             # per k: position (in off list) of I
    upd_b: List[np.ndarray]             # per k: position of J
    pool_init: np.ndarray               # (T, B, B) f32 initial tiles
    flops_true: int                     # scalar factorization flops
    flops_padded: int                   # dense-tile flops actually issued
    lnz: int

    @property
    def waste_ratio(self) -> float:
        return 1.0 - self.flops_true / max(self.flops_padded, 1)


def plan_cholesky(A: CSCMatrix, order: int = 1,
                  block: Optional[int] = None) -> CholPlan:
    """Host planning: AMD ordering, block fill, slot assignment, tile
    scatter, op lists (runs once per pattern — SURVEY.md §7.0)."""
    n = A.n
    B = block or min(default_block(), max(8, round_up(n, 8)))
    if order == 4:                        # RCM: band-friendly tiles
        from ..symbolic.rcm import rcm
        p = rcm(A)
    else:
        p = amd(order, A)
    piv = _pinv(p) if p is not None else None
    C = permute(A, piv, p, values=True) if p is not None else A
    nb = round_up(n, B) // B
    # exact scalar fill -> exact tile pattern (see _tile_pattern)
    from ..symbolic.etree import counts, etree, post
    from ..core.ops import symperm
    Cu = symperm(A, piv, values=False)
    par = etree(Cu)
    cnt = counts(Cu, par, post(par))
    rowptr, entries = _scalar_row_patterns(Cu, par, cnt)
    tilepairs, colpat = _tile_pattern(n, B, rowptr, entries)
    # slot assignment: diagonal tiles first, then off-diagonals per column
    diag_id = np.zeros(nb, dtype=_IDX)
    slot_of = {}
    T = 0
    for k in range(nb):
        diag_id[k] = T
        slot_of[(k, k)] = T
        T += 1
    off_rows: List[np.ndarray] = []
    off_ids: List[np.ndarray] = []
    for k in range(nb):
        rows = sorted(i for i in colpat[k] if i > k)
        ids = []
        for i in rows:
            slot_of[(i, k)] = T
            ids.append(T)
            T += 1
        off_rows.append(np.asarray(rows, dtype=_IDX))
        off_ids.append(np.asarray(ids, dtype=_IDX))
    # update ops per panel — only where the destination tile exists in
    # the exact fill pattern (absent dst => structurally zero product)
    upd_dst, upd_a, upd_b = [], [], []
    for k in range(nb):
        rows = off_rows[k]
        dsts, aa, bb = [], [], []
        for bpos, J in enumerate(rows):
            for apos in range(bpos, len(rows)):
                I = rows[apos]
                key = (int(I), int(J))
                if key not in slot_of:
                    continue
                dsts.append(slot_of[key])
                aa.append(apos)
                bb.append(bpos)
        upd_dst.append(np.asarray(dsts, dtype=_IDX))
        upd_a.append(np.asarray(aa, dtype=_IDX))
        upd_b.append(np.asarray(bb, dtype=_IDX))
    # scatter C into the pool; padded diagonal gets 1.0 so the dense tile
    # Cholesky stays nonsingular
    pool = np.zeros((T, B, B), dtype=np.float32)
    cols = np.repeat(np.arange(n, dtype=_IDX), np.diff(C.indptr))
    ti = C.indices // B
    tj = cols // B
    keep = ti >= tj                      # lower triangle drives the factor
    for pos in np.flatnonzero(keep):
        i = int(C.indices[pos])
        j = int(cols[pos])
        s = slot_of[(i // B, j // B)]
        pool[s, i - (i // B) * B, j - (j // B) * B] = C.data[pos]
    for d in range(n, nb * B):           # padded diagonal
        k = d // B
        pool[diag_id[k], d - k * B, d - k * B] = 1.0
    # flop accounting (cnt computed above)
    lnz = int(cnt.sum())
    flops_true = int(np.sum(cnt.astype(np.float64) ** 2))
    fp = 0
    for k in range(nb):
        r = len(off_rows[k])
        fp += B ** 3 // 3 + r * B ** 3 + len(upd_dst[k]) * 2 * B ** 3
    return CholPlan(n=n, B=B, nb=nb, perm=p, pinv=piv, diag_id=diag_id,
                    off_ids=off_ids, off_rows=off_rows, upd_dst=upd_dst,
                    upd_a=upd_a, upd_b=upd_b, pool_init=pool,
                    flops_true=flops_true, flops_padded=fp, lnz=lnz)
