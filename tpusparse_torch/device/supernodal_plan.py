"""Host planner of the variable-width supernodal Cholesky engine.

A copy of tpusparse/device/supernodal.py:48-321 (``_pow2``,
``_split_widths``, ``_Snode``, ``SupernodalPlan``, ``plan_supernodal``)
apart from the import lines: that module imports jax at load time, and
this package must not.  ``_column_patterns`` comes from the port's
``patterns`` copy.  tests/test_torch_imports.py holds the text to the
original's, tests/test_torch_supernodal.py the plans bit for bit.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import permute, symperm
from ..core.perm import pinv as _pinv
from ..symbolic.amd import amd
from ..symbolic.etree import counts, etree, post
from .patterns import _column_patterns

__all__ = ["SupernodalPlan", "plan_supernodal"]

_IDX = np.int64


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _split_widths(w: int, wmax: int = 128) -> List[int]:
    """Split a supernode width into power-of-two chunks <= wmax."""
    out = []
    while w > 0:
        c = min(_pow2(w) if _pow2(w) == w else _pow2(w) // 2, wmax)
        c = min(c, w)
        out.append(c)
        w -= c
    return out


@dataclass
class _Snode:
    sid: int
    c0: int                 # first column
    w: int                  # exact width (power of two)
    rows: np.ndarray        # od rows (below the diagonal block), sorted
    level: int = 0
    bucket: Tuple[int, int] = None     # (R, W)
    slot: int = 0                      # index within its bucket array


@dataclass
class SupernodalPlan:
    n: int
    perm: Optional[np.ndarray]
    snodes: List[_Snode]
    col2sn: np.ndarray
    nlevels: int
    buckets: List[Tuple[int, int]]                  # ordered bucket keys
    pool_init: Dict[Tuple[int, int], np.ndarray]    # bucket -> (cnt,R,W)
    # per level: factor membership per bucket: bucket -> slot array
    level_factor: List[Dict[Tuple[int, int], np.ndarray]]
    # per level: update groups keyed (d_bucket, s_bucket):
    #   (s_slots (P,), G1 (P,Rs), G0 (P,Ws), d_slots (P,)) — update
    #   blocks computed directly as L1 @ L0^T from row slab-gathers of
    #   the factored descendant panels (no multifrontal U matrices)
    level_updates: List[Dict[Tuple, Tuple]]
    flops_true: int
    flops_padded: int
    lnz: int

    @property
    def waste_ratio(self) -> float:
        return 1.0 - self.flops_true / max(self.flops_padded, 1)



def plan_supernodal(A: CSCMatrix, order: int = 1, wmax: int = 128,
                    tau: float = 0.1, small_w: int = 128) -> SupernodalPlan:
    n = A.n
    # ordering composed with postorder so supernodes are contiguous
    p = amd(order, A)
    if p is None:
        p = np.arange(n, dtype=_IDX)
    piv = _pinv(p)
    Cu0 = symperm(A, piv, values=False)
    par0 = etree(Cu0)
    po = post(par0)
    p = p[po]
    piv = _pinv(p)
    Cu = symperm(A, piv, values=False)
    parent = etree(Cu)
    porder = post(parent)
    cnt = counts(Cu, parent, porder)
    colptr, colrows = _column_patterns(Cu, parent, cnt)

    # --- fundamental supernodes --------------------------------------------
    # j, j+1 merge iff parent(j) = j+1 and cnt(j+1) = cnt(j) - 1
    starts = [0]
    for j in range(n - 1):
        if not (parent[j] == j + 1 and cnt[j + 1] == cnt[j] - 1):
            starts.append(j + 1)
    starts.append(n)
    # --- relaxed amalgamation ------------------------------------------------
    # greedily merge CONSECUTIVE supernodes while the merged panel stays
    # dense enough (merging is always correct — it only adds padding
    # zeros whose L values are structurally zero; classic relaxed
    # supernodes a la CHOLMOD). Defaults are AGGRESSIVE (tau=0.1,
    # small_w=wmax): on accelerators dispatch count dominates, and on
    # the 3D-AMD benchmark this cuts levels 409 -> 87 for +23% issued
    # flops (still 3.6x below the fixed-tile engine).
    groups = []           # (c0, c1, od_rows ndarray, nnz_true)
    for i in range(len(starts) - 1):
        c0, c1 = starts[i], starts[i + 1]
        rows_full = colrows[colptr[c0]:colptr[c0 + 1]]
        od = rows_full[rows_full >= c1]
        nnz_true = int(cnt[c0:c1].sum())
        groups.append([c0, c1, np.asarray(od, _IDX), nnz_true])
    merged = [groups[0]] if groups else []
    for g in groups[1:]:
        a = merged[-1]
        w_m = g[1] - a[0]
        if w_m <= wmax:
            od_m = np.union1d(a[2], g[2])
            od_m = od_m[od_m >= g[1]]
            r_m = w_m + od_m.size
            nnz_m = a[3] + g[3]
            dens = nnz_m / max(r_m * w_m, 1)
            if dens >= tau or w_m <= small_w:
                merged[-1] = [a[0], g[1], od_m, nnz_m]
                continue
        merged.append(g)
    # --- split merged groups to pow2 widths <= wmax --------------------------
    snodes: List[_Snode] = []
    col2sn = np.zeros(n, dtype=_IDX)
    for c0, c1, od_rows, _nnz in merged:
        off = c0
        for w in _split_widths(c1 - c0, wmax):
            # chunk od rows: the group's remaining columns + group od rows
            rest_cols = np.arange(off + w, c1, dtype=_IDX)
            rows = np.concatenate([rest_cols, od_rows])
            sid = len(snodes)
            snodes.append(_Snode(sid=sid, c0=off, w=w,
                                 rows=np.asarray(rows, _IDX)))
            col2sn[off:off + w] = sid
            off += w

    # --- supernode etree levels ------------------------------------------
    # parent supernode = supernode of the first od row (if any)
    sn_parent = np.full(len(snodes), -1, dtype=_IDX)
    for s in snodes:
        if s.rows.size:
            sn_parent[s.sid] = col2sn[s.rows[0]]
    level = np.zeros(len(snodes), dtype=_IDX)
    for sid in range(len(snodes)):              # children come first
        pa = sn_parent[sid]
        if pa != -1:
            level[pa] = max(level[pa], level[sid] + 1)
    # ... but updates can jump levels (d updates non-parent ancestors);
    # enforce level(s) > level(d) for every update pair below
    for s in snodes:
        for r in s.rows:
            t = int(col2sn[r])
            level[t] = max(level[t], level[s.sid] + 1)
    nlevels = int(level.max()) + 1 if snodes else 0
    for s in snodes:
        s.level = int(level[s.sid])

    # --- buckets and slots -------------------------------------------------
    bucket_count: Dict[Tuple[int, int], int] = defaultdict(int)
    for s in snodes:
        r = s.w + s.rows.size
        R = max(-(-r // 8) * 8, 8)               # round rows up to 8
        s.bucket = (R, s.w)
        s.slot = bucket_count[s.bucket]
        bucket_count[s.bucket] += 1
    buckets = sorted(bucket_count)
    pool_init = {b: np.zeros((bucket_count[b], b[0], b[1]), np.float32)
                 for b in buckets}

    # scatter A (lower triangle of the permuted matrix) into panels
    C = permute(A, piv, p, values=True)
    Cp, Ci, Cx = C.indptr, C.indices, C.data
    # local row index within each panel: diagonal cols 0..w-1 then od rows
    rowpos = {}                      # (sid, global row) -> panel row
    for s in snodes:
        for t in range(s.w):
            rowpos[(s.sid, s.c0 + t)] = t
        for q, r in enumerate(s.rows):
            rowpos[(s.sid, int(r))] = s.w + q
    for j in range(n):
        sid = int(col2sn[j])
        s = snodes[sid]
        lc = j - s.c0
        seg = slice(Cp[j], Cp[j + 1])
        for i, x in zip(Ci[seg], Cx[seg]):
            if i < j:
                continue
            pool_init[s.bucket][s.slot, rowpos[(sid, int(i))], lc] = x
    # identity padding on unused diagonal rows (rows r..R-1 are zero rows;
    # the W x W diagonal block is exact, so no diagonal padding needed)

    # --- schedules ----------------------------------------------------------
    level_factor: List[Dict] = [defaultdict(list) for _ in range(nlevels)]
    for s in snodes:
        level_factor[s.level][s.bucket].append(s.slot)
    level_factor = [
        {b: np.asarray(v, np.int32) for b, v in lf.items()}
        for lf in level_factor]

    # update pairs (d -> s): the update block is computed DIRECTLY as
    # L1 @ L0^T from row slab-gathers of the factored descendant panel —
    # no multifrontal U matrices at all.  This is strictly cheaper than
    # SYRK + selection (sum over targets of Rs*Ws <= Rq^2) and avoids
    # element gathers (~16x slower than slab gathers on this backend).
    # Groups keyed (d_bucket, s_bucket) so one reshape serves the batch.
    level_updates: List[Dict] = [
        defaultdict(lambda: ([], [], [], []))
        for _ in range(nlevels)]
    for d in snodes:
        if d.rows.size == 0:
            continue
        tgt = col2sn[d.rows]
        for t in np.unique(tgt):
            s = snodes[int(t)]
            sel = np.flatnonzero(tgt == t)       # positions in d.rows
            drows = d.rows[sel]
            Rs, Ws = s.bucket
            G1 = np.full(Rs, -1, np.int64)       # s-panel-row -> d od-pos
            G0 = np.full(Ws, -1, np.int64)       # s-panel-col -> d od-pos
            incol = drows < s.c0 + s.w
            for pos, r in zip(sel[incol], drows[incol]):
                G0[int(r - s.c0)] = pos
            # target rows: ALL of d's od rows >= s.c0; rows absent from
            # s's panel carry structurally-zero values (relaxed padding)
            ge = np.flatnonzero(d.rows >= s.c0)
            for pos in ge:
                pr = rowpos.get((s.sid, int(d.rows[pos])))
                if pr is not None:
                    G1[pr] = pos
            grp = level_updates[s.level][(d.bucket, s.bucket)]
            grp[0].append(s.slot)
            grp[1].append(G1)
            grp[2].append(G0)
            grp[3].append(d.slot)
    level_updates2 = []
    for lu in level_updates:
        out = {}
        for k, v in lu.items():
            out[k] = (np.asarray(v[0], np.int32),
                      np.stack(v[1]).astype(np.int64),   # G1 (P, Rs)
                      np.stack(v[2]).astype(np.int64),   # G0 (P, Ws)
                      np.asarray(v[3], np.int64))        # dslot (P,)
        level_updates2.append(out)
    level_updates = level_updates2

    # --- flop accounting ----------------------------------------------------
    lnz = int(cnt.sum())
    flops_true = int(np.sum(cnt.astype(np.float64) ** 2))
    fp = 0
    for s in snodes:
        R, W = s.bucket
        fp += W ** 3 // 3 + (R - W) * W * W            # chol + trsm
    for lu in level_updates:
        for (db, sb), (ssl, *_rest) in lu.items():
            # direct update GEMMs: (Rs x Wd) @ (Wd x Ws) per pair
            fp += 2 * len(ssl) * sb[0] * db[1] * sb[1]
    return SupernodalPlan(
        n=n, perm=p, snodes=snodes, col2sn=col2sn, nlevels=nlevels,
        buckets=buckets, pool_init=pool_init, level_factor=level_factor,
        level_updates=level_updates, flops_true=flops_true,
        flops_padded=fp, lnz=lnz)
