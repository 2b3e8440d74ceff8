"""Host planner of the multifrontal sparse Householder QR.

A copy of tpusparse/device/mfqr.py:96-503 (``_padded_flops``,
``_cluster_shapes``, ``_ground``, ``_Front``, ``MfqrPlan``, ``plan_mfqr``)
apart from the import lines: that module imports jax at load time, and
this package must not.  ``_split_widths`` comes from the port's
``supernodal_plan`` copy.  tests/test_torch_imports.py holds the text to
the original's, tests/test_torch_mfqr.py the plans bit for bit.
``TPUSPARSE_QR_SHAPES`` (default 16) caps the bucket shapes, as there.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import permute, transpose
from ..symbolic.amd import amd
from ..symbolic.etree import counts, etree, post

__all__ = ["MfqrPlan", "plan_mfqr"]

_IDX = np.int64


def _padded_flops(Rh: int, Ch: int) -> float:
    """Closed-form padded front-QR flops sum_{j<ke} 4(Rh-j)(Ch-j),
    ke = min(Rh, Ch)."""
    ke = min(Rh, Ch)
    return 4.0 * (ke * Rh * Ch - (Rh + Ch) * ke * (ke - 1) / 2.0
                  + (ke - 1) * ke * (2 * ke - 1) / 6.0)


def _cluster_shapes(counts: Dict[Tuple[int, int], int],
                    K: int) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """Cluster the distinct (Rh, Ch) bucket shapes into <= K cover
    shapes (elementwise max), greedily merging the pair whose merge
    adds the least padded front flops.  Bounding the shape menu bounds
    the compiled-program count: every per-bucket kernel family compiles
    one program per shape, and the assembly families one per shape
    PAIR — unbounded menus compiled 3,637 programs at n=65,536
    (VERDICT r3 item 1).  Small fronts absorb padding cheaply (their
    flops are negligible), so the greedy spends the budget keeping the
    big-front shapes tight."""
    shapes = sorted(counts)
    if len(shapes) <= K:
        return {s: s for s in shapes}
    clusters = {s: [s] for s in shapes}          # cover -> member shapes
    cover_of = {s: s for s in shapes}
    while len(clusters) > K:
        keys = list(clusters)
        best = None
        for i in range(len(keys)):
            a = keys[i]
            for j in range(i + 1, len(keys)):
                b = keys[j]
                cov = (max(a[0], b[0]), max(a[1], b[1]))
                pf = _padded_flops(*cov)
                cost = sum(counts[s] * (pf - _padded_flops(*cover_of[s]))
                           for s in clusters[a] + clusters[b])
                if best is None or cost < best[0]:
                    best = (cost, a, b, cov)
        _, a, b, cov = best
        members = clusters.pop(a) + clusters.pop(b)
        if cov in clusters:                      # cover may collide
            members += clusters.pop(cov)
        clusters[cov] = members
        for s in members:
            cover_of[s] = cov
    return cover_of


def _ground(x: int) -> int:
    """Round a front dimension up to its bucket size: 1.5x-power-of-two
    steps {8, 12, 16, 24, 32, 48, 64, 96, 128} below 128 (33%/dim waste
    bound, few buckets for the many small fronts), multiples of 32
    above (12.5%/dim bound where the flops actually are — measured on
    the n=16,384 LS bench: waste 0.419 -> 0.184, issued flops -29%,
    for +23% compiled programs)."""
    if x <= 8:
        return 8
    if x > 128:
        return -(-x // 32) * 32
    p = 8
    while True:
        if x <= p:
            return p
        if x <= p + p // 2:
            return p + p // 2
        p *= 2


@dataclass
class _Front:
    sid: int
    c0: int
    w: int
    od: np.ndarray              # contribution col ids (global, sorted)
    rows_a: np.ndarray          # original row ids assigned to this front
    nrow_real: int = 0
    nrow_eff: int = 0
    kstar: int = 0              # min(nrow_eff, ncol) — eliminated cols
    cr: int = 0                 # contribution rows = kstar - w
    level: int = 0
    bucket: Tuple[int, int] = None
    slot: int = 0
    comp_off: int = 0
    children: List[int] = field(default_factory=list)
    child_base: Dict[int, int] = field(default_factory=dict)

    @property
    def ncol(self) -> int:
        return self.w + self.od.size


@dataclass
class MfqrPlan:
    m: int
    n: int
    q: np.ndarray                                  # final column perm
    fronts: List[_Front]
    col2sn: np.ndarray
    nlevels: int
    buckets: List[Tuple[int, int]]
    bucket_count: Dict[Tuple[int, int], int]
    pool_init: Dict[Tuple[int, int], np.ndarray]
    level_factor: List[Dict]                       # bucket -> slots
    level_assemble: List[Dict]                     # (cb,pb) -> maps
    level_disassemble: List[Dict]                  # same, keyed child lvl
    level_io: List[Dict]                           # bucket -> (slots,bidx,outmap)
    level_rsolve: List[Dict]          # bucket -> (slots,colsJ,odidx,wvec)
    pass_rows: np.ndarray
    pass_slots: np.ndarray
    ysize: int
    ncomp: int
    flops_true: int
    flops_padded: int
    rnz: int
    vnz: int

    @property
    def waste_ratio(self) -> float:
        return 1.0 - self.flops_true / max(self.flops_padded, 1)


def plan_mfqr(A: CSCMatrix, order: int = 3, wmax: int = 64,
              small_w: int = 8, amalg_tau: float = 0.35) -> MfqrPlan:
    """Host symbolic analysis + front/bucket/level schedule construction
    (the reference's cs_sqr analysis driving a multifrontal plan).
    TPUSPARSE_PLAN_TIMING=1 prints per-section timers."""
    import os as _os
    import time as _time
    _timing = _os.environ.get("TPUSPARSE_PLAN_TIMING") == "1"
    _t = [_time.time()]

    def _tick(label):
        if _timing:
            now = _time.time()
            print(f"plan_mfqr[{label}]: {now - _t[0]:.2f}s", flush=True)
            _t[0] = now

    m, n = A.m, A.n
    if m < n:
        raise ValueError("m >= n required (caller factors A')")
    if n == 0:
        raise ValueError("empty matrix")
    # 1. ordering composed with a column-etree postorder ------------------
    q = amd(order, A)
    qq = q if q is not None else np.arange(n, dtype=_IDX)
    Aq = permute(A, None, qq, values=True)
    parent0 = etree(Aq, ata=True)
    po = post(parent0)
    q2 = np.asarray(qq, _IDX)[po]
    Aq = permute(A, None, q2, values=True)
    parent = etree(Aq, ata=True)
    porder = post(parent)
    cnt = counts(Aq, parent, porder, ata=True)     # R row counts
    _tick("symbolic")

    # 2. supernodes of the column etree -----------------------------------
    starts = [0]
    for j in range(n - 1):
        if not (parent[j] == j + 1 and cnt[j + 1] == cnt[j] - 1):
            starts.append(j + 1)
    starts.append(n)
    groups = []                       # [c0, c1, nnzR_true]
    for i in range(len(starts) - 1):
        c0, c1 = starts[i], starts[i + 1]
        groups.append([c0, c1, int(cnt[c0:c1].sum())])
    merged = [groups[0]]
    for g in groups[1:]:
        a = merged[-1]
        w_m = g[1] - a[0]
        if w_m <= wmax and parent[a[1] - 1] == a[1]:
            # R-pattern density estimate (nested-pattern approximation)
            od_est = max(int(cnt[a[0]]) - (g[1] - a[0]), 0)
            dens = (a[2] + g[2]) / max(w_m * (w_m + od_est), 1)
            if w_m <= small_w or dens >= amalg_tau:
                merged[-1] = [a[0], g[1], a[2] + g[2]]
                continue
        merged.append(g)
    from .supernodal_plan import _split_widths
    sn_ranges: List[Tuple[int, int]] = []
    col2sn = np.zeros(n, dtype=_IDX)
    for c0, c1, _nnz in merged:
        off = c0
        for w in _split_widths(c1 - c0, wmax):
            col2sn[off:off + w] = len(sn_ranges)
            sn_ranges.append((off, off + w))
            off += w

    _tick("pre-snodes")
    # 3. row assignment by leftmost column --------------------------------
    AqT = transpose(Aq, values=True)               # CSR view of Aq
    Tp, Ti, Tx = AqT.indptr, AqT.indices, AqT.data
    rdeg = np.diff(Tp)
    leftmost = np.full(m, -1, dtype=_IDX)
    nz_rows = np.flatnonzero(rdeg > 0)
    leftmost[nz_rows] = Ti[Tp[:-1][nz_rows]]       # cols sorted per row
    rows_by_sn: Dict[int, List[int]] = defaultdict(list)
    for i in nz_rows:
        rows_by_sn[int(col2sn[leftmost[i]])].append(int(i))

    _tick("pre-fronts")
    # 4. recursive front construction (ascending sid = topological) -------
    fronts: List[_Front] = []
    pend_children: Dict[int, List[int]] = defaultdict(list)
    for sid, (c0, c1) in enumerate(sn_ranges):
        w = c1 - c0
        rows_a = np.asarray(rows_by_sn.get(sid, []), _IDX)
        col_parts = [np.zeros(0, _IDX)]
        for i in rows_a:
            seg = Ti[Tp[i]:Tp[i + 1]]
            lo = np.searchsorted(seg, c1)
            col_parts.append(seg[lo:])
        kids = pend_children.get(sid, [])
        for c in kids:
            fc = fronts[c]
            col_parts.append(fc.od[fc.od >= c1])
        od = np.unique(np.concatenate(col_parts))
        f = _Front(sid=sid, c0=c0, w=w, od=od, rows_a=rows_a)
        f.children = kids
        f.nrow_real = len(rows_a) + sum(fronts[c].cr for c in kids)
        f.nrow_eff = max(f.nrow_real, w)           # fictitious zero rows
        f.kstar = min(f.nrow_eff, f.ncol)
        f.cr = f.kstar - w
        base = len(rows_a)
        for c in kids:
            f.child_base[c] = base
            base += fronts[c].cr
        if f.cr > 0 and od.size:
            pend_children[int(col2sn[od[0]])].append(sid)
        fronts.append(f)

    _tick("pre-levels")
    # 5. levels (factor deps via contributions; solve deps via od cols) ---
    nf = len(fronts)
    level = np.zeros(nf, dtype=_IDX)
    for f in fronts:
        if f.od.size:
            for t in np.unique(col2sn[f.od]):
                level[t] = max(level[t], level[f.sid] + 1)
    nlevels = int(level.max()) + 1 if nf else 0
    for f in fronts:
        f.level = int(level[f.sid])

    _tick("pre-pools")
    # 6. buckets, slots, pools ---------------------------------------------
    # ground shapes, then cluster the shape menu to <= TPUSPARSE_QR_SHAPES
    # cover shapes (default 24): the compiled-program count scales with
    # the menu (and with its PAIRS for assembly), so an unbounded menu
    # is the flagship QR's prewarm wall; the flop-weighted greedy keeps
    # the waste added by the cap small (measured n=8,192: menu 140 ->
    # 24 costs waste 0.040 -> 0.110 while programs drop ~6.5x).
    grounds = [(_ground(max(f.nrow_eff, 8)), _ground(max(f.ncol, 8)))
               for f in fronts]
    gcnt: Dict[Tuple[int, int], int] = defaultdict(int)
    for g in grounds:
        gcnt[g] += 1
    # 16 shapes x 6 grouped-kernel families = 96 programs <= the 100-
    # program budget (VERDICT r4 item 2); measured at the 16,384 x
    # 8,192 bench problem the 24 -> 16 trim costs waste 0.3814 ->
    # 0.3868 — negligible against a 144 -> 96 first-run compile cut.
    nshapes = int(_os.environ.get("TPUSPARSE_QR_SHAPES", "16"))
    cover_of = _cluster_shapes(dict(gcnt), nshapes)
    bucket_count: Dict[Tuple[int, int], int] = defaultdict(int)
    for f, g in zip(fronts, grounds):
        f.bucket = cover_of[g]
        f.slot = bucket_count[f.bucket]
        bucket_count[f.bucket] += 1
    buckets = sorted(bucket_count)
    pool_init = {b: np.zeros((bucket_count[b], b[0], b[1]), np.float32)
                 for b in buckets}
    for f in fronts:                               # scatter A rows
        P = pool_init[f.bucket]
        for rs, i in enumerate(f.rows_a):
            seg = slice(Tp[i], Tp[i + 1])
            cols_i = Ti[seg]
            piv = cols_i < f.c0 + f.w
            P[f.slot, rs, cols_i[piv] - f.c0] = Tx[seg][piv]
            rest = cols_i[~piv]
            if rest.size:
                pos = np.searchsorted(f.od, rest)
                P[f.slot, rs, f.w + pos] = Tx[seg][~piv]

    _tick("pre-coords")
    # 7. complement/output coordinates -------------------------------------
    ncomp = 0
    for f in fronts:
        f.comp_off = n + ncomp
        ncomp += f.nrow_real - f.kstar
    pass_rows = np.flatnonzero(leftmost < 0).astype(_IDX)
    pass_slots = n + ncomp + np.arange(pass_rows.size, dtype=_IDX)
    ysize = n + ncomp + pass_rows.size
    TRASH = ysize

    _tick("pre-schedules")
    # 8. schedules ----------------------------------------------------------
    level_factor: List[Dict] = [defaultdict(list) for _ in range(nlevels)]
    level_io: List[Dict] = [defaultdict(list) for _ in range(nlevels)]
    level_rsolve: List[Dict] = [defaultdict(list) for _ in range(nlevels)]
    level_assemble: List[Dict] = [
        defaultdict(lambda: ([], [], [], [])) for _ in range(nlevels)]
    level_disassemble: List[Dict] = [
        defaultdict(lambda: ([], [], [], [])) for _ in range(nlevels)]
    for f in fronts:
        Rh, Ch = f.bucket
        WB = min(Rh, Ch, wmax)          # R-solve block width (>= any w)
        level_factor[f.level][f.bucket].append(f.slot)
        bidx = np.full(Rh, -1, _IDX)
        bidx[:len(f.rows_a)] = f.rows_a
        outmap = np.full(Rh, TRASH, _IDX)
        outmap[:f.w] = np.arange(f.c0, f.c0 + f.w)
        ncm = f.nrow_real - f.kstar
        if ncm > 0:
            outmap[f.kstar:f.nrow_real] = f.comp_off + np.arange(ncm)
        level_io[f.level][f.bucket].append((f.slot, bidx, outmap))
        # R/R'-solve maps: buffer cols [0, WB) form the triangular
        # block (pivot cols, then leading od cols as identity rows —
        # the front width w is runtime DATA, not a bucket static);
        # cols [WB, Ch) are gathered od contributions.
        colsJ = np.full(WB, n, _IDX)
        colsJ[:f.w] = np.arange(f.c0, f.c0 + f.w)
        lead = min(WB - f.w, f.od.size)
        colsJ[f.w:f.w + lead] = f.od[:lead]
        odidx = np.full(Ch - WB, n, _IDX)
        rest = f.od[WB - f.w:] if f.od.size > WB - f.w else f.od[:0]
        odidx[:rest.size] = rest
        level_rsolve[f.level][f.bucket].append(
            (f.slot, colsJ, odidx, f.w))
        # contribution maps child -> parent
        for c in f.children:
            fc = fronts[c]
            RM = np.full(Rh, -1, _IDX)
            base = f.child_base[c]
            RM[base:base + fc.cr] = fc.w + np.arange(fc.cr)
            CM = np.full(Ch, -1, _IDX)
            gcols = np.concatenate(
                [np.arange(f.c0, f.c0 + f.w, dtype=_IDX), f.od])
            pos = np.searchsorted(fc.od, gcols)
            ok = (pos < fc.od.size)
            ok[ok] = fc.od[pos[ok]] == gcols[ok]
            CM[:gcols.size][ok] = fc.w + pos[ok]
            grp = level_assemble[f.level][(fc.bucket, f.bucket)]
            grp[0].append(f.slot)
            grp[1].append(fc.slot)
            grp[2].append(RM)
            grp[3].append(CM)
            grp2 = level_disassemble[fc.level][(fc.bucket, f.bucket)]
            grp2[0].append(f.slot)
            grp2[1].append(fc.slot)
            grp2[2].append(RM)
            grp2[3].append(CM)

    def _pack_pairs(levels):
        out = []
        for lu in levels:
            d = {}
            for k, (psl, csl, RMs, CMs) in lu.items():
                d[k] = (np.asarray(psl, np.int32),
                        np.asarray(csl, np.int32),
                        np.stack(RMs).astype(np.int32),
                        np.stack(CMs).astype(np.int32))
            out.append(d)
        return out

    level_assemble = _pack_pairs(level_assemble)
    level_disassemble = _pack_pairs(level_disassemble)
    level_factor = [{b: np.asarray(v, np.int32) for b, v in lf.items()}
                    for lf in level_factor]
    level_io2 = []
    for li in level_io:
        d = {}
        for b, items in li.items():
            items.sort(key=lambda t: t[0])
            d[b] = (np.asarray([t[0] for t in items], np.int32),
                    np.stack([t[1] for t in items]).astype(np.int32),
                    np.stack([t[2] for t in items]).astype(np.int32))
        level_io2.append(d)
    level_rsolve2 = []
    for lr in level_rsolve:
        d = {}
        for b, items in lr.items():
            items.sort(key=lambda t: t[0])
            d[b] = (np.asarray([t[0] for t in items], np.int32),
                    np.stack([t[1] for t in items]).astype(np.int32),
                    np.stack([t[2] for t in items]).astype(np.int32),
                    np.asarray([t[3] for t in items], np.int32))
        level_rsolve2.append(d)

    _tick("pre-flops")
    # 9. flop accounting -----------------------------------------------------
    ft = fp = 0
    rnz = int(cnt.sum())
    vnz = 0
    for f in fronts:
        j = np.arange(f.kstar, dtype=np.float64)
        ft += int(np.sum(4.0 * (f.nrow_real - j) * (f.ncol - j)))
        Rh, Ch = f.bucket
        ke = min(Rh, Ch)
        jj = np.arange(ke, dtype=np.float64)
        fp += int(np.sum(4.0 * (Rh - jj) * (Ch - jj)))
        vnz += int(np.sum(np.maximum(f.nrow_real - j, 0)))
    _tick("final")
    return MfqrPlan(
        m=m, n=n, q=q2, fronts=fronts, col2sn=col2sn, nlevels=nlevels,
        buckets=buckets, bucket_count=dict(bucket_count),
        pool_init=pool_init, level_factor=level_factor,
        level_assemble=level_assemble,
        level_disassemble=level_disassemble, level_io=level_io2,
        level_rsolve=level_rsolve2, pass_rows=pass_rows,
        pass_slots=pass_slots, ysize=ysize, ncomp=ncomp,
        flops_true=ft, flops_padded=fp, rnz=rnz, vnz=vnz)
