"""Multifrontal sparse Householder QR on a torch device, with the true Q
(counterpart of ``MultifrontalQR`` in tpusparse/device/mfqr.py, its
bucket dispatch).  Reference: csparse::cs_qr / cs_house / cs_happly /
cs_qrsol (SURVEY.md §3.3).

The plan (``mfqr_plan.plan_mfqr``, a copy of the JAX planner) cuts A(:, q)
into dense padded fronts, one per supernode of the column elimination
tree, batched per (etree level, bucket shape).  Its schedules go to the
device once, as index tensors; then, level by level:

* factor: each child's upper-trapezoidal contribution block is added
  into its parent's front (an index gather and ``index_add_``), then the
  level's fronts of one bucket are gathered, factored by the blocked
  Householder QR of ``dense.qr_factor_partial`` (the panel kernel H2 and
  three batched products per panel of 8 columns) and written back.  The
  V / R pools and the taus stay on the device;
* Q^T b / Q y (``apply_qt`` / ``apply_q``, the reference's cs_happly as
  an operator): per level, the fronts' vectors are gathered from b (or
  from y) and from the children's (or the parent's) vectors, then the
  reflector kernel H3 applies each front's reflectors in place;
* R / R^T solves: per level, a batched triangular solve of each front's
  leading block against its coupling to the already solved columns.

``solve_ls`` and ``solve_minnorm`` follow cs_qrsol, inside f64
augmented-system refinement on the host (contraction ~kappa(A) eps_f32:
Q is exact, so not the kappa^2 of the Q-less ``SparseQR``).
``extract_R`` reads R from the pools as a host CSC on its true pattern.

Spans (utils/profiling.py, recorded only while recording is on): the
root ``mfqr.factor`` (counts ``panels``, the H2 launches of the call,
and ``sched_uploads``, 1 in the factor that built the device schedule
or uploaded the scattered A), its ``.upload`` (``h2d_bytes``), one
``.assemble`` and one ``.fronts`` (``panels``) a level, and ``.check``
around the rank check's one host sync.

Structural rank follows cs_qr's fictitious rows: a front with fewer rows
than pivot columns is padded with zero rows, whose reflectors are the
identity (tau = 0) and whose R diagonal is exactly zero, so ``factor``
returns False (``rank_ok``).

Not ported: the JAX package's group dispatch (mfqr_group.py, bit for bit
the bucket dispatch's results, there to bound the number of compiled
programs), its compile machinery (``prewarm``, ``n_programs``,
``_kernel_jobs``, ``_K_CACHE``, ``_dispatch``, device/compilepool.py),
the padding of batches to a few sizes (``_gbatch``, ``_padrep``) and two
workarounds for its device compiler (``_gather1d``; the one-hot
contribution product of ``_k_qt_contrib``).  The port computes the same
results without them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.matrix import CSCMatrix
from ..core.ops import gaxpy, norm1, transpose
from ..utils.profiling import Metrics, span
from ..utils.profiling import add as count
from .dense import qr_factor_partial
from .kernels import qr_apply
from .mfqr_plan import MfqrPlan, plan_mfqr
from .batching import one, whole

__all__ = ["MfqrPlan", "plan_mfqr", "MultifrontalQR"]

_BS = 8          # Householder panel width inside a front


def _pairs(psl, csl, RM, Rhp: int, Rhc: int) -> tuple:
    """The contribution rows of a (child bucket, parent bucket) group:
    for every child row mapped into its parent (RM >= 0), the flat row
    index in the parent pool (slot * Rhp + r) and in the child pool
    (slot * Rhc + RM), the group member it belongs to, and RM itself."""
    pp, rr = np.nonzero(RM >= 0)
    crow = RM[pp, rr].astype(np.int64)
    dst = psl[pp].astype(np.int64) * Rhp + rr
    src = csl[pp].astype(np.int64) * Rhc + crow
    return dst, src, pp, crow


class _Sched:
    """The plan's schedules as index tensors on the device (uploaded once,
    so the factor and the passes move no schedule from the host), each
    list indexed by level; ``nbytes`` the bytes uploaded, ``panels`` the
    H2 launches of each level's fronts in a factor."""

    def __init__(self, plan: MfqrPlan, device: torch.device):
        self.nbytes = 0

        def t(a, dtype=torch.int64):
            out = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
            self.nbytes += out.nbytes
            return out

        m, n, ysize = plan.m, plan.n, plan.ysize
        L = plan.nlevels
        self.factor: List[list] = [[] for _ in range(L)]
        self.assemble: List[list] = [[] for _ in range(L)]
        self.disassemble: List[list] = [[] for _ in range(L)]
        self.io: List[list] = [[] for _ in range(L)]
        self.rsolve: List[list] = [[] for _ in range(L)]
        for lvl in range(L):
            for b, slots in plan.level_factor[lvl].items():
                self.factor[lvl].append((b, min(b), t(slots)))
            for (cb, pb), (psl, csl, RM, CM) in \
                    plan.level_assemble[lvl].items():
                dst, src, pp, crow = _pairs(psl, csl, RM, pb[0], cb[0])
                self.assemble[lvl].append(
                    (cb, pb, t(dst), t(src), t(pp), t(crow),
                     t(CM), t(np.maximum(CM, 0))))
            for (cb, pb), (psl, csl, RM, _CM) in \
                    plan.level_disassemble[lvl].items():
                dst, src, _, _ = _pairs(psl, csl, RM, pb[0], cb[0])
                self.disassemble[lvl].append((cb, pb, t(dst), t(src)))
            for b, (slots, bidx, outmap) in plan.level_io[lvl].items():
                Rh = b[0]
                flat = (slots.astype(np.int64)[:, None] * Rh
                        + np.arange(Rh)).reshape(-1)
                bidx, outmap = bidx.reshape(-1), outmap.reshape(-1)
                bok, yok = bidx >= 0, outmap < ysize
                self.io[lvl].append(dict(
                    b=b, kelim=min(b), slots=t(slots),
                    # Q^T: front rows from b (row m of bpad is 0) ...
                    bgather=t(np.where(bok, bidx, m)),
                    # ... and the front's outputs into y
                    ysrc=t(flat[yok]), ydst=t(outmap[yok]),
                    # Q: front rows from y (row ysize of ypad is 0) ...
                    ygather=t(np.where(yok, outmap, ysize)),
                    # ... and the front's rows of A into b
                    bsrc=t(flat[bok]), bdst=t(bidx[bok])))
            for b, (slots, colsJ, odidx, wv) in \
                    plan.level_rsolve[lvl].items():
                WB = colsJ.shape[1]
                piv = np.arange(WB)[None, :] < wv[:, None]
                self.rsolve[lvl].append(dict(
                    b=b, WB=WB, slots=t(slots), colsJ=t(colsJ),
                    colsJc=t(np.minimum(colsJ, n - 1)), odidx=t(odidx),
                    piv=t(piv, torch.bool),
                    rtset=t(np.where(piv, colsJ, n)),
                    rtadd=t(np.where(piv, n, colsJ))))
        self.panels = [sum(-(-kelim // _BS) for _, kelim, _ in lv)
                       for lv in self.factor]
        self.pass_rows = t(plan.pass_rows)
        self.pass_slots = t(plan.pass_slots)
        self.eye = {}
        for lv in self.rsolve:
            for e in lv:
                if e["WB"] not in self.eye:
                    self.eye[e["WB"]] = torch.eye(e["WB"], device=device)


_FAR = 1 << 30   # a pattern row past every front's


def _r_pattern(plan: MfqrPlan, A: CSCMatrix) -> dict:
    """R's true pattern in the pools: {bucket: (c0, w, gcol, first)} as
    host int64 arrays, c0 and w (S,) the slots' first pivot and pivot
    count, gcol and first (S, Ch).  Column c of slot s's front is the
    permuted column gcol[s, c] (n past the front's columns), and front
    row r < w, R's row c0 + r, holds R's entry in it where
    first[s, c] <= r <= c.

    Row merge inside a front: its pivots are a chain of the column
    etree, and the rows eliminated at pivot j carry on as one row to
    j + 1, so R's row j holds column k from the first pivot at which a
    front row that holds k is eliminated.  A front's rows are its rows
    of A(:, q), each eliminated at its leftmost column, and the
    contribution of each child, whose first row holds the child's whole
    od and is eliminated at od[0] (its further rows hold less of od).
    This is the pattern ``plan.rnz`` counts.  Outside it, the positions
    that amalgamation adds to a front's R rows are zero in exact
    arithmetic and hold zeros or rounding (the dense front's products
    that cancel there).  Vectorised over all fronts at once."""
    n, fronts = plan.n, plan.fronts
    nf = len(fronts)

    def per_front(attr):
        return np.fromiter((getattr(f, attr) for f in fronts), np.int64, nf)
    c0, w, cr, slot = (per_front(a) for a in ("c0", "w", "cr", "slot"))
    nod = np.fromiter((f.od.size for f in fronts), np.int64, nf)
    bnum = {b: i for i, b in enumerate(plan.buckets)}
    fb = np.fromiter((bnum[f.bucket] for f in fronts), np.int64, nf)
    od = np.concatenate([f.od for f in fronts]).astype(np.int64)

    def spread(counts):
        """(front, position in its run) of runs of ``counts`` a front."""
        fid = np.repeat(np.arange(nf), counts)
        starts = np.cumsum(counts) - counts
        return fid, np.arange(fid.size) - starts[fid]
    pf, pp = spread(w)                              # pivot columns
    of, op = spread(nod)                            # od columns
    colf = np.concatenate([pf, of])
    colpos = np.concatenate([pp, w[of] + op])
    colk = np.concatenate([c0[pf] + pp, od])

    # candidates (front, column, pivot where a row holding it is
    # eliminated): the rows of A(:, q) ...
    qinv = np.empty(n, np.int64)
    qinv[plan.q] = np.arange(n)
    rows = A.indices
    kq = qinv[np.repeat(np.arange(n), np.diff(A.indptr))]
    leftmost = np.full(A.m, n, np.int64)
    np.minimum.at(leftmost, rows, kq)
    lm = leftmost[rows]
    # ... and each child's first contribution row
    odfirst = np.zeros(nf, np.int64)
    odfirst[nod > 0] = od[(np.cumsum(nod) - nod)[nod > 0]]
    kid = (cr[of] > 0)
    cand_f = np.concatenate([plan.col2sn[lm], plan.col2sn[odfirst[of]][kid]])
    cand_k = np.concatenate([kq, od[kid]])
    cand_v = np.concatenate([lm, odfirst[of][kid]])
    key = cand_f * (n + 1) + cand_k
    order = np.lexsort((cand_v, key))
    key, cand_v = key[order], cand_v[order]
    head = np.r_[True, key[1:] != key[:-1]]
    ukey, uval = key[head], cand_v[head]
    ckey = colf * (n + 1) + colk
    at = np.minimum(np.searchsorted(ukey, ckey), max(ukey.size - 1, 0))
    found = ukey[at] == ckey
    first = np.where(found, uval[at] - c0[colf], _FAR)

    out = {}
    for b in plan.buckets:
        S, Ch = plan.bucket_count[b], b[1]
        gcol = np.full((S, Ch), n, np.int64)
        fst = np.full((S, Ch), _FAR, np.int64)
        sel = fb[colf] == bnum[b]
        gcol[slot[colf[sel]], colpos[sel]] = colk[sel]
        fst[slot[colf[sel]], colpos[sel]] = first[sel]
        mine = fb == bnum[b]
        bc0, bw = np.zeros(S, np.int64), np.zeros(S, np.int64)
        bc0[slot[mine]], bw[slot[mine]] = c0[mine], w[mine]
        out[b] = (bc0, bw, gcol, fst)
    return out


class MultifrontalQR:
    """Device sparse Householder QR with the true Q (same contracts as the
    JAX ``MultifrontalQR``): A(:, q) = Q R, the V / R pools and the taus on
    ``device``; ``apply_qt`` / ``apply_q`` are cs_happly as an operator,
    ``solve_ls`` / ``solve_minnorm`` follow cs_qrsol with f64 refinement.

    ``device`` defaults to "cuda", so a machine without a card fails here
    instead of running on the CPU; the CPU runs the plain versions of the
    kernels.  ``plan_kw`` goes to ``plan_mfqr`` (wmax, small_w,
    amalg_tau)."""

    def __init__(self, A: CSCMatrix, order: int = 3, device="cuda",
                 **plan_kw):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultifrontalQR: device 'cuda' requested "
                               "but torch.cuda.is_available() is False")
        if A.m < A.n:
            raise ValueError("m >= n required (caller factors A')")
        self.A = A
        self.At = transpose(A, values=True)
        self.plan = plan_mfqr(A, order=order, **plan_kw)
        self._sched_cache: _Sched = None
        self._pool0: Dict[Tuple[int, int], torch.Tensor] = None
        # rank-check maps: per bucket the pivot count of every slot and
        # the width of the block whose diagonal holds R's
        wb_all = {}
        for f in self.plan.fronts:
            wb_all.setdefault(f.bucket, np.zeros(
                self.plan.bucket_count[f.bucket], np.int64))[f.slot] = f.w
        self._rdiag_maps = {
            b: (torch.as_tensor(wv, device=self.device),
                min(b[0], b[1], max(int(wv.max()), 1)))
            for b, wv in wb_all.items()}
        self.pools = None
        self.taus = None
        self.rank_ok = False
        self.last_info = {}
        self._rpat = None                # R's pattern, made by extract_R

    @property
    def _sched(self) -> _Sched:
        """The device schedule, built on first use."""
        if self._sched_cache is None:
            self._sched_cache = _Sched(self.plan, self.device)
        return self._sched_cache

    def factor(self) -> bool:
        plan = self.plan
        with span("mfqr.factor") as root:
            with span("mfqr.factor.upload") as up:
                first = self._sched_cache is None or self._pool0 is None
                h2d = 0
                if self._sched_cache is None:
                    h2d += self._sched.nbytes
                if self._pool0 is None:      # the scattered A, uploaded once
                    self._pool0 = {b: torch.from_numpy(v).to(self.device)
                                   for b, v in plan.pool_init.items()}
                    h2d += sum(v.nbytes for v in self._pool0.values())
                pools = {b: v.clone() for b, v in self._pool0.items()}
                taus = {b: torch.zeros((plan.bucket_count[b], b[1]),
                                       device=self.device)
                        for b in plan.buckets}
                if up:
                    count("h2d_bytes", h2d)
            self._factor_pools(pools, taus)
            with span("mfqr.factor.check"):
                mn, finite = self._rdiag_check(pools)
            if root:
                count("panels", sum(self._sched.panels))
                count("sched_uploads", int(first))
        self.rank_ok = finite and mn > 0.0
        if finite:
            self.pools, self.taus = pools, taus
        return self.rank_ok

    def _factor_pools(self, pools, taus, batches=whole) -> None:
        """The level loop of the factor, in place on ``pools`` (the
        scattered A) and ``taus`` (zeros); a bucket batch of fronts is
        factored by ``qr_factor_partial`` through ``batches``
        (device/batching.py).  Each level's assembly and fronts run in
        spans ``mfqr.factor.assemble`` and ``mfqr.factor.fronts``, the
        latter counting its H2 launches (``panels``)."""
        plan, sched = self.plan, self._sched
        for lvl in range(plan.nlevels):
            with span("mfqr.factor.assemble"):
                for cb, pb, dst, src, pp, crow, CM, CMc in \
                        sched.assemble[lvl]:
                    # the child rows, spread to the parent's columns; only
                    # the upper trapezoid (parent column map >= child row)
                    rows = pools[cb].view(-1, cb[1]).index_select(0, src)
                    vals = rows.gather(1, CMc.index_select(0, pp))
                    keep = CM.index_select(0, pp) >= crow[:, None]
                    pools[pb].view(-1, pb[1]).index_add_(0, dst,
                                                         vals * keep)
            with span("mfqr.factor.fronts") as fr:
                for b, kelim, sl in sched.factor[lvl]:
                    Mb = pools[b].index_select(0, sl)
                    tb = torch.zeros((sl.shape[0], b[1]), device=self.device)

                    def part(lo, hi):
                        qr_factor_partial(Mb[lo:hi], tb[lo:hi], _BS, kelim)
                        return Mb[lo:hi], tb[lo:hi]
                    Mb, tb = one(batches, sl.shape[0], part)
                    pools[b].index_copy_(0, sl, Mb)
                    taus[b].index_copy_(0, sl, tb)
                if fr:
                    count("panels", sched.panels[lvl])

    def _rdiag_check(self, pools) -> tuple:
        """(min |R_kk| over the pivot columns, all-finite) of the factored
        pools, in one host read."""
        out = []
        for b in self.plan.buckets:
            wv, WB = self._rdiag_maps[b]
            P = pools[b]
            d = torch.diagonal(P[:, :WB, :WB], dim1=1, dim2=2).abs()
            d = torch.where(torch.arange(WB, device=P.device) < wv[:, None],
                            d, torch.inf)
            out += [d.min(), torch.isfinite(P).all().to(d.dtype)]
        got = torch.stack(out).tolist()
        return min(got[0::2]), all(f == 1.0 for f in got[1::2])

    def _check_rank(self) -> bool:
        """Re-run the rank check on already-loaded pools (the checkpoint
        restore path for files without the rank_ok field)."""
        if self.pools is None:
            return False
        mn, finite = self._rdiag_check(self.pools)
        return finite and mn > 0.0

    def extract_R(self) -> CSCMatrix:
        """The factored pools as a host CSC R (n x n, upper triangular, in
        the permuted column order A(:, q), ``plan.q``; true pattern only,
        ``plan.rnz`` entries, rows sorted in each column), so that
        A(:, q) = Q R with R's rows signed as the pools hold them; the
        rounding that a front holds outside the pattern is left out.  Read
        a bucket at a time on the pools' device; the pattern
        (``_r_pattern``) is made once per plan, on the host."""
        if self.pools is None:
            raise ValueError("factor() first")
        n, dev = self.plan.n, self.device
        if self._rpat is None:
            self._rpat = _r_pattern(self.plan, self.A)
        rows, cols, vals = [], [], []
        for b, (c0, w, gcol, first) in self._rpat.items():
            WB = int(w.max())
            r = torch.arange(WB, device=dev)[None, :, None]
            c = torch.arange(b[1], device=dev)[None, None, :]
            w_t = torch.as_tensor(w, device=dev)[:, None, None]
            first_t = torch.as_tensor(first, device=dev)[:, None, :]
            s, rr, cc = ((first_t <= r) & (r <= c) & (r < w_t)).nonzero(
                as_tuple=True)
            vals.append(self.pools[b][s, rr, cc])
            rows.append(torch.as_tensor(c0, device=dev)[s] + rr)
            cols.append(torch.as_tensor(gcol, device=dev)[s, cc])
        rows, cols, vals = (torch.cat(v) for v in (rows, cols, vals))
        order = torch.argsort(cols * n + rows)
        cols = cols[order].cpu().numpy()
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(cols, minlength=n), out=indptr[1:])
        return CSCMatrix(n, n, indptr, rows[order].cpu().numpy(),
                         vals[order].cpu().numpy().astype(np.float64))

    # ------------------------------------------------------- raw passes
    def _zbufs(self) -> dict:
        """One vector per front, per bucket (S, Rh)."""
        return {b: torch.zeros((self.plan.bucket_count[b], b[0]),
                               device=self.device)
                for b in self.plan.buckets}

    def _qt_pass(self, bpad: torch.Tensor, batches=whole) -> torch.Tensor:
        """Q^T b: bpad (m+1,) f32 with bpad[m] = 0 -> ypad (ysize+1,) f32
        with ypad[ysize] = 0.  A batch of fronts' reflectors is applied
        by ``qr_apply`` through ``batches`` (device/batching.py)."""
        plan, sched = self.plan, self._sched
        ypad = torch.zeros(plan.ysize + 1, device=self.device)
        ypad[sched.pass_slots] = bpad[sched.pass_rows]
        z = self._zbufs()
        for lvl in range(plan.nlevels):
            for e in sched.io[lvl]:
                b = e["b"]
                z[b].index_copy_(0, e["slots"], bpad.index_select(
                    0, e["bgather"]).view(-1, b[0]))
            for cb, pb, dst, src, *_ in sched.assemble[lvl]:
                z[pb].view(-1).index_add_(
                    0, dst, z[cb].view(-1).index_select(0, src))
            for e in sched.io[lvl]:
                b, sl = e["b"], e["slots"]

                def part(lo, hi):
                    qr_apply(self.pools[b], self.taus[b], sl[lo:hi], z[b],
                             e["kelim"], True)
                    return (z[b].index_select(0, sl[lo:hi]),)
                zs, = one(batches, sl.shape[0], part)
                z[b].index_copy_(0, sl, zs)
                ypad.index_copy_(0, e["ydst"],
                                 z[b].view(-1).index_select(0, e["ysrc"]))
        return ypad

    def _q_pass(self, ypad: torch.Tensor) -> torch.Tensor:
        """Q y: ypad (ysize+1,) f32 with ypad[ysize] = 0 -> bpad (m+1,)
        f32 with bpad[m] = 0."""
        plan, sched = self.plan, self._sched
        bvec = torch.zeros(plan.m + 1, device=self.device)
        bvec[sched.pass_rows] = ypad[sched.pass_slots]
        z = self._zbufs()
        for lvl in range(plan.nlevels - 1, -1, -1):
            for e in sched.io[lvl]:
                b = e["b"]
                z[b].index_copy_(0, e["slots"], ypad.index_select(
                    0, e["ygather"]).view(-1, b[0]))
            for cb, pb, dst, src in sched.disassemble[lvl]:
                z[cb].view(-1).index_copy_(
                    0, src, z[pb].view(-1).index_select(0, dst))
            for e in sched.io[lvl]:
                b = e["b"]
                qr_apply(self.pools[b], self.taus[b], e["slots"], z[b],
                         e["kelim"], False)
                bvec.index_copy_(0, e["bdst"],
                                 z[b].view(-1).index_select(0, e["bsrc"]))
        return bvec

    def _rsolve_front(self, e: dict, y: torch.Tensor, xpad: torch.Tensor,
                      lo: int, hi: int) -> tuple:
        """(xJ,) of the fronts [lo, hi) of an rsolve batch: the WB x WB
        leading block solved; its rows at or past the front's width w are
        identity equations whose right-hand side is the already solved x
        at that od column."""
        b, WB = e["b"], e["WB"]
        P = self.pools[b][:, :WB].index_select(0, e["slots"][lo:hi])
        piv = e["piv"][lo:hi]
        RJJ = torch.where(piv[:, :, None], P[:, :, :WB].triu(),
                          self._sched.eye[WB])
        rhs = y[e["colsJc"][lo:hi]]
        if b[1] > WB:
            rhs = rhs - torch.bmm(P[:, :, WB:],
                                  xpad[e["odidx"][lo:hi]][:, :, None])[..., 0]
        rhs = torch.where(piv, rhs, xpad[e["colsJ"][lo:hi]])
        return (torch.linalg.solve_triangular(RJJ, rhs[:, :, None],
                                              upper=True)[..., 0],)

    def _rsolve_pass(self, y: torch.Tensor, batches=whole) -> torch.Tensor:
        """x = R \\ y for y (n,) f32, reverse level order; a batch of
        fronts goes through ``batches`` (device/batching.py)."""
        plan, sched = self.plan, self._sched
        xpad = torch.zeros(plan.n + 1, device=self.device)
        for lvl in range(plan.nlevels - 1, -1, -1):
            for e in reversed(sched.rsolve[lvl]):
                xJ, = one(batches, e["slots"].shape[0], lambda lo, hi:
                          self._rsolve_front(e, y, xpad, lo, hi))
                xpad[e["colsJ"]] = xJ
        return xpad[:plan.n]

    def _rtsolve_pass(self, bq: torch.Tensor) -> torch.Tensor:
        """z = R^T \\ bq for bq (n,) f32, forward level order; a front's
        identity rows (>= w) add their update to the od column they stand
        for, so fronts that share an od column accumulate."""
        plan, sched = self.plan, self._sched
        n = plan.n
        ypad = torch.cat([bq, torch.zeros(1, device=self.device)])
        for lvl in range(plan.nlevels):
            for e in sched.rsolve[lvl]:
                b, WB = e["b"], e["WB"]
                P = self.pools[b][:, :WB].index_select(0, e["slots"])
                piv = e["piv"]
                RJJ = torch.where(piv[:, :, None], P[:, :, :WB].triu(),
                                  sched.eye[WB])
                rhs = ypad[e["colsJ"]]
                zJ = torch.linalg.solve_triangular(
                    RJJ.transpose(1, 2), rhs[:, :, None], upper=False)[..., 0]
                ypad[e["rtset"]] = torch.where(piv, zJ, 0.0)
                ypad.index_add_(0, e["rtadd"].view(-1),
                                torch.where(piv, 0.0, zJ - rhs).view(-1))
                if b[1] > WB:
                    delta = torch.bmm(P[:, :, WB:].transpose(1, 2),
                                      (zJ * piv)[:, :, None])[..., 0]
                    ypad.index_add_(0, e["odidx"].view(-1),
                                    -delta.reshape(-1))
                ypad[n] = 0.0
        return ypad[:n]

    # ---------------------------------------------------------- operators
    def _qt_np(self, v: np.ndarray) -> np.ndarray:
        bpad = np.zeros(self.plan.m + 1, np.float32)
        bpad[:self.plan.m] = v
        out = self._qt_pass(torch.from_numpy(bpad).to(self.device))
        return out.cpu().numpy().astype(np.float64)[:self.plan.ysize]

    def _q_np(self, y: np.ndarray) -> np.ndarray:
        ypad = np.zeros(self.plan.ysize + 1, np.float32)
        ypad[:len(y)] = y
        out = self._q_pass(torch.from_numpy(ypad).to(self.device))
        return out.cpu().numpy().astype(np.float64)[:self.plan.m]

    def _rsolve_np(self, y: np.ndarray) -> np.ndarray:
        y = torch.from_numpy(np.asarray(y, np.float32)).to(self.device)
        return self._rsolve_pass(y).cpu().numpy().astype(np.float64)

    def _rtsolve_np(self, bq: np.ndarray) -> np.ndarray:
        bq = torch.from_numpy(np.asarray(bq, np.float32)).to(self.device)
        return self._rtsolve_pass(bq).cpu().numpy().astype(np.float64)

    def apply_qt(self, b: np.ndarray) -> np.ndarray:
        """y = Q' b (length plan.ysize; y[:n] are the R-row coords)."""
        return self._qt_np(np.asarray(b, np.float64))

    def apply_q(self, y: np.ndarray) -> np.ndarray:
        """b = Q y for y of length plan.ysize (inverse of apply_qt)."""
        return self._q_np(np.asarray(y, np.float64))

    def _aug_solve(self, f1: np.ndarray, f2q: np.ndarray):
        """Exact augmented-system solve (Bjorck) using the true Q:
        [[I, Aq], [Aq', 0]] [dr; dxq] = [f1; f2q] via
        h = R'^{-1} f2q;  g = Q'f1;  dxq = R^{-1}(g[:n] - h);
        dr = Q [h; g[n:]].  All four device-resident passes."""
        n = self.plan.n
        h = self._rtsolve_np(f2q)
        g = self._qt_np(f1)
        dxq = self._rsolve_np(g[:n] - h)
        y = g.copy()
        y[:n] = h
        dr = self._q_np(y)
        return dr, dxq

    def solve_ls(self, b: np.ndarray, refine_iters: int = 4,
                 rtol: float = 1e-14) -> np.ndarray:
        """min ||A x - b||: augmented-system iterative refinement with
        the EXACT Q (contraction ~kappa(A)*eps_f32; converges to the
        true LS solution AND residual, unlike plain QR refinement whose
        floor is eps_f32*||r||)."""
        if not self.rank_ok:
            raise ValueError("rank deficient")
        if refine_iters < 1:
            raise ValueError("refine_iters must be >= 1 (the first "
                             "iteration computes the base solution)")
        b = np.asarray(b, np.float64)
        plan = self.plan
        x = np.zeros(plan.n)
        r = np.zeros(plan.m)
        nrmA = norm1(self.A)
        ne = true = np.inf
        for it in range(refine_iters):
            f1 = b - r - gaxpy(self.A, x, np.zeros(plan.m))
            f2 = -gaxpy(self.At, r, np.zeros(plan.n))
            scale = nrmA * max(np.abs(x).max(), 0.0) + np.abs(b).max()
            true = np.abs(f1).max() / max(scale, 1e-300)
            ne = np.abs(f2).max() / max(nrmA * scale, 1e-300)
            if max(ne, true) < rtol:
                break
            dr, dxq = self._aug_solve(f1, f2[plan.q])
            dx = np.zeros(plan.n)
            dx[plan.q] = dxq
            x = x + dx
            r = r + dr
        self.last_info = {"iters": it + 1, "ne_resid": float(ne),
                          "aug_resid": float(true)}
        return x

    def solve_minnorm(self, b: np.ndarray, refine_iters: int = 4,
                      rtol: float = 1e-14) -> np.ndarray:
        """This object factors B = A_orig' (tall); returns the min-norm
        solution of A_orig x = b: x = Q [R'^{-1} b_q; 0], refined on the
        KKT system (x = B lam, B'x = b) so the nullspace component is
        removed to f64 grade as well."""
        if not self.rank_ok:
            raise ValueError("rank deficient")
        if refine_iters < 1:
            raise ValueError("refine_iters must be >= 1 (the first "
                             "iteration computes the base solution)")
        b = np.asarray(b, np.float64)
        plan = self.plan
        x = np.zeros(plan.m)                        # len = cols of A_orig
        lamq = np.zeros(plan.n)                     # multiplier, permuted
        eq = np.inf
        nrmB = norm1(self.A)
        for it in range(refine_iters):
            # f1 = B lam - x  (x in range(B));  f2 = b - B' x.  lam
            # lives in the permuted column coordinate of Bq = B(:, q):
            # map back through plan.q before the unpermuted SpMV.
            lam_full = np.zeros(plan.n)
            lam_full[plan.q] = lamq
            f1 = gaxpy(self.A, lam_full, np.zeros(plan.m)) - x
            f2 = b - gaxpy(self.At, x, np.zeros(plan.n))
            eq = np.abs(f2).max() / max(
                nrmB * max(np.abs(x).max(), 0.0) + np.abs(b).max(),
                1e-300)
            if eq < rtol and np.abs(f1).max() < rtol * max(
                    np.abs(x).max(), 1.0):
                break
            # dx = Q [u; g2], dlamq = R^{-1}(u - g1), u = R'^{-1} f2q
            u = self._rtsolve_np(f2[plan.q])
            g = self._qt_np(f1)
            dlamq = self._rsolve_np(u - g[:plan.n])
            y = g.copy()
            y[:plan.n] = u
            dx = self._q_np(y)
            x = x + dx
            lamq = lamq + dlamq
        self.last_info = {"iters": it + 1, "eq_resid": float(eq)}
        return x

    def metrics(self) -> Metrics:
        plan = self.plan
        m = Metrics()
        m.record(qr_engine="multifrontal",
                 qr_fronts=len(plan.fronts),
                 qr_buckets=len(plan.buckets),
                 qr_levels=plan.nlevels,
                 qr_flops_true=int(plan.flops_true),
                 qr_flops_padded=int(plan.flops_padded),
                 qr_waste_ratio=float(plan.waste_ratio),
                 qr_rnz=int(plan.rnz), qr_vnz=int(plan.vnz))
        return m
