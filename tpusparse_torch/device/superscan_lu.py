"""Sparse supernodal LU with within-panel threshold pivoting in PyTorch:
factor and device-resident solves.

Port of tpusparse/device/superscan_lu.py.  The structure is the JAX
package's: the matrix is optionally row-matched (bottleneck transversal),
its pattern symmetrized, and ONE superscan plan (``plan_superscan`` with
``lu_extras=True``, the copied planner) drives two mirrored pools, L
column panels and U row panels, kept in a dict keyed by ("L", pool
width) and ("U", pool width).

Factor: the host step loop of ``superscan._factor`` with three LU phases
per step, in sorted key order:
  update (d -> s):  dL = L1 U0^T into L[tgt], dU = U1 L0^T into U[tgtu]
                    (masked gathers, two ``bmm``, ``index_add_`` into
                    clamped targets; tgtu < 0 marks the diagonal block,
                    whose rows add exact zeros to row 0);
  panel LU:         ``kernels.lu_tiles_pool`` on the W x W diagonal
                    blocks, in place (threshold pivoting inside the
                    block, tiny pivots perturbed to +-eps), F into the L
                    pool, the one-hot P into the U pool's diagonal slot;
  trsm:             L od rows <- X U_D^-1 and U od rows <- (X P^T) L_D^-T,
                    two launches of ``kernels.trsm_tiles_batched`` (which
                    solves Y = X L^-T and reads L's lower triangle only):
                    with U_D^T, made contiguous, and with the unit lower
                    L_D, its diagonal set to 1.  X P^T is a column gather
                    by the pivot order.
Then one stacked reduction and one host sync give finiteness and the
pivot growth max|L\\U| / max|A|.

Solve: the superscan solve schedule (copied ``_solve_xs``), forward
(P as a gather, unit-lower diagonal solve, od GEMVs from the L pool) and
backward (od GEMVs from the U pool, upper diagonal solve), on an
(n + 1, k) right-hand side, then host f64 refinement.

Not ported: the TPUSPARSE_LU_HOST_SOLVE switch of ``solve`` (the host
extract path is ``solve_host``), and what serves the JAX compile cache
(``_JIT_CACHE``, ``compile_many``, ``_pools_sig``, ``_sched_dev``).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.matrix import COOMatrix, CSCMatrix
from ..core.ops import add, permute, transpose
from ..core.perm import ipvec, pvec, pinv as _pinv
from ..symbolic.transversal import bottleneck_transversal, diag_dominance
from ..utils.profiling import Metrics
from .config import DTYPE
from .kernels import lu_tiles_pool, trsm_tiles_batched
from .refine import refine
from .refine_many import refine_many
from .superscan import _Consts, _Packed, _factor, pools_from_numpy
from .superscan_plan import _IDX, _solve_xs, plan_superscan

__all__ = ["SuperscanLU"]

LUPools = Dict[Tuple[str, int], torch.Tensor]


# ------------------------------------------------------------------ factor
def _upd(pools: LUPools, key: tuple, a: Dict[str, torch.Tensor],
         c: _Consts) -> None:
    """dL = L1 U0^T and dU = U1 L0^T from the pools of width pd,
    scatter-subtracted into those of width ps (JAX: superscan_lu.py:171-207).
    Padded slots carry -1 and gather row 0 under a false mask."""
    kind, pd, ps, H, Wd, Ws = key
    Ld, Ud = pools[("L", pd)][:, :Wd], pools[("U", pd)][:, :Wd]
    src, l0i = a["src"], a["l0"]
    ms, m0 = (src >= 0)[..., None], (l0i >= 0)[..., None]
    s, t = src.clamp(min=0), l0i.clamp(min=0)
    l1 = torch.where(ms, Ld[s], c.zero)
    u1 = torch.where(ms, Ud[s], c.zero)
    u0 = torch.where(m0, Ud[t], c.zero)
    l0 = torch.where(m0, Ld[t], c.zero)
    dL = torch.bmm(l1, u0.mT)                              # (bs, H, Ws)
    dU = torch.where((a["tgtu"] >= 0)[..., None], torch.bmm(u1, l0.mT),
                     c.zero)
    for side, tgt, delta in (("L", a["tgt"], dL), ("U", a["tgtu"], dU)):
        acc = pools[(side, ps)]
        if kind == "upds":
            flat = tgt.clamp(min=0)[:, :, None] * ps + a["cmap"][:, None, :]
            acc.view(-1).index_add_(0, flat.reshape(-1), delta.reshape(-1),
                                    alpha=-1)
        else:
            acc[:, :Ws].index_add_(0, tgt.clamp(min=0).reshape(-1),
                                   delta.reshape(-1, Ws), alpha=-1)


def _panel(pools: LUPools, key: tuple, a: Dict[str, torch.Tensor],
           c: _Consts, eps: float, tol: float) -> None:
    """Pivoted LU of the diagonal blocks (JAX: superscan_lu.py:208-233),
    in place in the pools: F into the L pool, the one-hot P into the U
    pool, as full pool rows (one launch of ``lu_tiles_pool``)."""
    _, pw, W = key
    lu_tiles_pool(pools[("L", pw)], pools[("U", pw)], a["dbase"], W, eps,
                  tol)


def _trsm(pools: LUPools, key: tuple, a: Dict[str, torch.Tensor],
          c: _Consts, tol: float) -> None:
    """L od rows <- X U_D^-1, U od rows <- (X P^T) L_D^-T (JAX:
    superscan_lu.py:234-263), both by the per-slot trsm kernel, written
    back as full pool rows.  Padded rows point at the dump row."""
    _, pw, H, W = key
    accL, accU = pools[("L", pw)], pools[("U", pw)]
    slL, slU = accL[:, :W], accU[:, :W]
    rows = a["rows"]                                       # (bs, H)
    didx = a["dbase"][:, None] + c.arange(W)
    Dk = slL[didx]                                         # packed L\U
    YL = trsm_tiles_batched(Dk.mT.contiguous(), slL[rows])
    XU = slU[rows]
    if tol != 0.0:
        # U od rows see the pivoted block rows: XU P^T, a column gather
        perm = slU[didx].argmax(dim=-1)                    # P[i, perm[i]]
        XU = XU.gather(2, perm[:, None, :].expand(-1, H, -1))
    YU = trsm_tiles_batched(torch.tril(Dk, -1) + c.eye(W), XU)
    r = rows.reshape(-1)
    accL.index_copy_(0, r, F.pad(YL, (0, pw - W)).reshape(-1, pw))
    accU.index_copy_(0, r, F.pad(YU, (0, pw - W)).reshape(-1, pw))


def _phases(eps: float, tol: float) -> tuple:
    return ((("upd", "upds"), _upd),
            (("chol",), functools.partial(_panel, eps=eps, tol=tol)),
            (("trsm",), functools.partial(_trsm, tol=tol)))


# ------------------------------------------------------------------- solve
def _diag_solve(pools: LUPools, key: tuple, a, xpad: torch.Tensor,
                c: _Consts, backward: bool) -> None:
    """Forward: x[cols] <- L_D^-1 P x[cols] (unit lower); backward:
    x[cols] <- U_D^-1 x[cols] (JAX: superscan_lu.py:284-300, :334-346)."""
    _, pw, W = key
    idx = a["dbase"][:, None] + c.arange(W)
    Dk = pools[("L", pw)][:, :W][idx]                      # (U, W, W)
    cols = a["cols"]
    xc = xpad[cols]                                        # (U, W, k)
    if backward:
        y = torch.linalg.solve_triangular(Dk, xc, upper=True)
    else:
        perm = pools[("U", pw)][:, :W][idx].argmax(dim=-1)
        xc = xc.gather(1, perm[..., None].expand(-1, -1, xc.shape[-1]))
        y = torch.linalg.solve_triangular(Dk, xc, upper=False,
                                          unitriangular=True)
    xpad.index_copy_(0, cols.reshape(-1), y.reshape(-1, xpad.shape[1]))


def _od_solve(pools: LUPools, key: tuple, a, xpad: torch.Tensor,
              c: _Consts, backward: bool) -> None:
    """The od GEMVs of each trsm slot, L pool forward and U pool backward,
    scatter-subtracted into x (JAX: superscan_lu.py:301-316, :318-333).
    Rows whose target is the pad entry n are masked out."""
    _, pw, H, W = key
    nn, k = xpad.shape[0] - 1, xpad.shape[1]
    mask = (a["tgt"] < nn)[..., None]
    Y = torch.where(mask, pools[("U" if backward else "L", pw)][:, :W]
                    [a["rows"]], c.zero)                   # (U, H, W)
    if backward:
        xod = torch.where(mask, xpad[a["tgt"]], c.zero)    # (U, H, k)
        xpad.index_add_(0, a["cols"].reshape(-1),
                        torch.bmm(Y.mT, xod).reshape(-1, k), alpha=-1)
    else:
        xpad.index_add_(0, a["tgt"].reshape(-1),
                        torch.bmm(Y, xpad[a["cols"]]).reshape(-1, k),
                        alpha=-1)


def _segment_solve(xs, pools: LUPools, xpad: torch.Tensor, c: _Consts,
                   backward: bool) -> None:
    keys = sorted(xs)
    ck = [k for k in keys if k[0] == "chol"]
    tk = [k for k in keys if k[0] == "trsm"]
    nn = xpad.shape[0] - 1
    steps = next(iter(xs[keys[0]].values())).shape[0]
    for step in (range(steps - 1, -1, -1) if backward else range(steps)):
        def at(k):
            return {nm: v[step] for nm, v in xs[k].items()}
        if not backward:
            for k in ck:
                _diag_solve(pools, k, at(k), xpad, c, False)
            for k in tk:
                _od_solve(pools, k, at(k), xpad, c, False)
        else:
            for k in tk:
                _od_solve(pools, k, at(k), xpad, c, True)
            for k in ck:
                _diag_solve(pools, k, at(k), xpad, c, True)
        xpad[nn] = 0.0


class SuperscanLU:
    """Within-panel-pivoted sparse LU: P_panel A(p,p) = L U on the
    symmetrized-pattern Cholesky fill, f32 on ``device`` + f64 refined
    device-resident solves (same contracts as the JAX ``SuperscanLU``).

    ``tol``: 1.0 = strict partial pivoting within each panel's diagonal
    block, 0.001 = diagonal-preferring, 0.0 = static pivoting (P = I).
    factor() returns False on a non-finite factor or a pivot growth above
    TPUSPARSE_LU_GROWTH_MAX (default 1e6); tiny pivots are perturbed and
    healed by refinement, and ``solve`` raises ValueError when refinement
    does not heal them.  ``device`` defaults to "cuda" and raises without
    a card; the CPU runs the kernels' plain versions.
    """

    def __init__(self, A: CSCMatrix, order: int = 1, wmax: int = None,
                 tau: float = 0.9, small_w: int = 8,
                 max_segments: int = 10, tol: float = 1.0,
                 match: object = "auto", device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SuperscanLU: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if A.m != A.n:
            raise ValueError("square matrix required")
        self.A = A
        self.tol = float(tol)
        n = A.n
        # bottleneck matching (symbolic.transversal): rows with weak
        # diagonals get a large matched entry pivoted onto the diagonal
        # before the symmetric-pattern analysis
        self._match_p = None
        self.match_alpha = None
        if match == "auto":
            match = n > 0 and A.nnz > 0 and diag_dominance(A) < 1e-2
        if match:
            mt = bottleneck_transversal(A)
            if mt is not None:
                p, alpha = mt
                if not np.array_equal(p, np.arange(n)):
                    self._match_p = p
                    self.match_alpha = alpha
                    A = permute(A, _pinv(p),
                                np.arange(n, dtype=_IDX), values=True)
        self._B = A                     # row-matched matrix (factored)
        # symmetrized pattern with guaranteed diagonal
        absA = CSCMatrix(n, n, A.indptr, A.indices, np.abs(A.data))
        S = add(absA, transpose(absA, values=True), 1.0, 1.0)
        eye = CSCMatrix(n, n, np.arange(n + 1, dtype=_IDX),
                        np.arange(n, dtype=_IDX), np.ones(n))
        S = add(S, eye, 1.0, 1.0)
        self.plan = plan_superscan(S, order=order, wmax=wmax, tau=tau,
                                   small_w=small_w,
                                   max_segments=max_segments,
                                   lu_extras=True)
        self._scatter_values()
        self.pools: LUPools = None
        self.growth = None              # max |L\U| / max |A| (factor())
        self.growth_exceeded = False
        self._LU_host = None
        self._factor_sched: _Packed = None
        self._solve_sched = None
        self._consts = _Consts(self.device)

    # ---------------------------------------------------------- planning
    def _scatter_values(self):
        """Scatter the (symmetrically) permuted A into mirrored L/U
        pools: lower+diag-block entries into Lpool, strict-upper od
        entries transposed into Upool."""
        plan = self.plan
        n = plan.n
        piv = _pinv(plan.perm)
        C = permute(self._B, piv, plan.perm, values=True)
        panels = plan.panels
        col2p = np.zeros(n, dtype=_IDX)
        for pl in panels:
            col2p[pl.c0:pl.c0 + pl.w] = pl.pid
        Lp = {pw: np.zeros_like(v) for pw, v in plan.pool_init.items()}
        Up = {pw: np.zeros_like(v) for pw, v in plan.pool_init.items()}
        for pw, v in plan.pool_init.items():
            # identity rows live beyond the real rows; panel width pads
            # are re-created below
            Lp[pw][plan.pool_rows[pw]:] = v[plan.pool_rows[pw]:]
        for pl in panels:                        # width-pad identities
            for t in range(pl.w, pl.W):
                Lp[pl.pool][pl.rbase + t, t] = 1.0
        Cp, Ci, Cx = C.indptr, C.indices, C.data
        cols_of = np.repeat(np.arange(n, dtype=_IDX), np.diff(Cp))
        for lower in (True, False):
            if lower:
                keep = Ci >= cols_of              # into Lpool via col panel
                pidx = col2p[cols_of[keep]]
            else:
                keep = Ci < cols_of               # into D-upper or Upool
                pidx = col2p[Ci[keep]]            # via ROW panel
            ei, ej, ex = Ci[keep], cols_of[keep], Cx[keep]
            o = np.argsort(pidx, kind="stable")
            ei, ej, ex, pidx = ei[o], ej[o], ex[o], pidx[o]
            bounds = np.searchsorted(pidx, np.arange(len(panels) + 1))
            for pl in panels:
                lo, hi = bounds[pl.pid], bounds[pl.pid + 1]
                if lo == hi:
                    continue
                ii, jj, xx = ei[lo:hi], ej[lo:hi], ex[lo:hi]
                if lower:
                    q = np.where(ii < pl.c0 + pl.w, ii - pl.c0,
                                 pl.W + np.searchsorted(pl.rows, ii))
                    Lp[pl.pool][pl.rbase + q, jj - pl.c0] = xx
                else:
                    ind = jj < pl.c0 + pl.w       # D upper part
                    Lp[pl.pool][pl.rbase + (ii[ind] - pl.c0),
                                jj[ind] - pl.c0] = xx[ind]
                    od = ~ind
                    q = pl.W + np.searchsorted(pl.rows, jj[od])
                    Up[pl.pool][pl.rbase + q, ii[od] - pl.c0] = xx[od]
        self._Lp0, self._Up0 = Lp, Up
        self._maxabs = float(np.abs(self._B.data).max()) if \
            self._B.nnz else 1.0

    # ------------------------------------------------------------ factor
    def load_pools(self, pools: Dict[Tuple[str, int], np.ndarray]) -> None:
        """Take factored pools from the host, e.g. the JAX package's
        ``{k: np.asarray(v) for k, v in F.pools.items()}``, keyed by
        ("L" | "U", pool width)."""
        self.pools = {(side, int(pw)): torch.tensor(
            np.asarray(v), dtype=DTYPE, device=self.device)
            for (side, pw), v in pools.items()}
        self._LU_host = None

    def factor(self) -> bool:
        plan = self.plan
        if self._factor_sched is None:
            self._factor_sched = _Packed([s.xs for s in plan.segments
                                          if s.xs])
        pools = {}
        for side, host in (("L", self._Lp0), ("U", self._Up0)):
            for pw, v in pools_from_numpy(host, self.device).items():
                pools[(side, pw)] = v
        eps = float(np.float32(1e-8 * self._maxabs))
        pools = _factor(plan, pools, self._factor_sched,
                        _phases(eps, self.tol))
        # the one host sync: finiteness and the pivot growth
        # max |L\U| / max |A| over the real rows of both pools (JAX:
        # superscan_lu.py:499-522).  Uncontained growth makes the f32
        # factor useless long before refinement would show it.
        real = [v[:plan.pool_rows[pw]] for (_, pw), v in pools.items()]
        finite = torch.stack([torch.isfinite(v).all() for v in real]).all()
        top = torch.stack([torch.nan_to_num(v, nan=0.0, posinf=0.0,
                                            neginf=0.0).abs().amax()
                           if v.numel() else self._consts.zero
                           for v in real]).amax()
        finite, gmax = torch.stack([finite.to(DTYPE), top]).tolist()
        self.growth = gmax / self._maxabs
        glim = float(os.environ.get("TPUSPARSE_LU_GROWTH_MAX", "1e6"))
        self.growth_exceeded = bool(self.growth > glim)
        ok = bool(finite) and not self.growth_exceeded
        self._LU_host = None
        if ok:
            self.pools = pools
        return ok

    # ------------------------------------------------------------- solve
    def _host_pools(self, side: str) -> Dict[int, np.ndarray]:
        return {pw: self.pools[(side, pw)].cpu().numpy()
                for pw in self.plan.pool_init}

    def _panel_pivots(self) -> Dict[int, np.ndarray]:
        """Host copy of each panel's local pivot order p (P[i, p_i]=1),
        read from the U pool's diag slots — checkpoint/extract path."""
        hostU = self._host_pools("U")
        return {pl.pid: np.argmax(
            hostU[pl.pool][pl.rbase:pl.rbase + pl.W, :pl.W],
            axis=1).astype(_IDX) for pl in self.plan.panels}

    def extract_LU(self) -> Tuple[CSCMatrix, CSCMatrix, np.ndarray]:
        """Host CSC L (unit diagonal explicit, diag first) and U (diag
        last per column) in PIVOTED permuted coordinates, plus pglob:
        the composed within-panel row pivot (pglob[i] = original
        permuted row at pivoted position i).  Checkpoint/debug path:
        solves are device-resident."""
        if self.pools is None:
            raise ValueError("factor() first")
        plan = self.plan
        n = plan.n
        hostL, hostU = self._host_pools("L"), self._host_pools("U")
        # composed pivot: pglob[pivoted] = original, pinv_g[original] ->
        # pivoted; identity outside true panel widths
        pglob = np.arange(n, dtype=_IDX)
        for pl in plan.panels:
            Pm = hostU[pl.pool][pl.rbase:pl.rbase + pl.w, :pl.W]
            pglob[pl.c0:pl.c0 + pl.w] = pl.c0 + np.argmax(Pm, axis=1)
        pinv_g = _pinv(pglob)
        li, lj, lx = [], [], []               # L: unit diag + lower
        ui, uj, ux = [], [], []               # U: upper incl diag
        for pl in plan.panels:
            bL = hostL[pl.pool]
            bU = hostU[pl.pool]
            w = pl.w
            D = bL[pl.rbase:pl.rbase + w, :w]
            # strict-lower of packed D -> L; upper incl diag -> U
            # (already in pivoted coordinates)
            r_lo, c_lo = np.tril_indices(w, -1)
            li.append(pl.c0 + r_lo)
            lj.append(pl.c0 + c_lo)
            lx.append(D[r_lo, c_lo])
            li.append(pl.c0 + np.arange(w))
            lj.append(pl.c0 + np.arange(w))
            lx.append(np.ones(w))
            r_up, c_up = np.triu_indices(w)
            ui.append(pl.c0 + r_up)
            uj.append(pl.c0 + c_up)
            ux.append(D[r_up, c_up])
            if pl.rows.size:
                od = bL[pl.rbase + pl.W:pl.rbase + pl.W + pl.rows.size, :w]
                # od L rows relabel through the ANCESTOR pivots
                li.append(np.repeat(pinv_g[pl.rows], w))
                lj.append(np.tile(pl.c0 + np.arange(w), pl.rows.size))
                lx.append(od.reshape(-1))
                odU = bU[pl.rbase + pl.W:pl.rbase + pl.W + pl.rows.size,
                         :w]
                # Upanel[q, t] = U[c0+t, rows[q]]; U columns are
                # variables — never relabeled by row pivoting
                ui.append(np.tile(pl.c0 + np.arange(w), pl.rows.size))
                uj.append(np.repeat(pl.rows, w))
                ux.append(odU.reshape(-1))
        L = COOMatrix(n, n, np.concatenate(li), np.concatenate(lj),
                      np.concatenate(lx)).tocsc()
        U = COOMatrix(n, n, np.concatenate(ui), np.concatenate(uj),
                      np.concatenate(ux)).tocsc()
        return L, U, pglob

    def _solve_f32_host(self, b: np.ndarray) -> np.ndarray:
        from ..numeric.trisolve import lsolve, usolve
        if self._LU_host is None:
            self._LU_host = self.extract_LU()
        L, U, pglob = self._LU_host
        b = np.asarray(b, np.float64)
        if self._match_p is not None:
            b = b[self._match_p]
        bp = pvec(self.plan.perm, b)
        xp = lsolve(L, bp[pglob])
        xp = usolve(U, xp)
        if xp is None:
            raise FloatingPointError("singular U")
        return ipvec(self.plan.perm, xp)

    def _sched(self):
        """The solve schedule, built and uploaded once, kept on the
        device."""
        if self._solve_sched is None:
            self._solve_sched = _Packed(
                [xs for xs in _solve_xs(self.plan) if xs]
            ).upload(self.device)
        return self._solve_sched

    def _solve_f32_many(self, Bm: np.ndarray) -> np.ndarray:
        """Forward then backward over the pools on the (n, k) right-hand
        sides at once, in f32; the factor never leaves the device."""
        plan = self.plan
        Bm = np.asarray(Bm, np.float64)
        if self._match_p is not None:
            Bm = Bm[self._match_p]
        xpad = np.zeros((plan.n + 1, Bm.shape[1]), dtype=np.float32)
        xpad[:plan.n] = Bm[plan.perm]
        xpad = torch.from_numpy(xpad).to(self.device)
        sched = self._sched()
        for xs in sched:
            _segment_solve(xs, self.pools, xpad, self._consts, False)
        for xs in reversed(sched):
            _segment_solve(xs, self.pools, xpad, self._consts, True)
        X = np.zeros((plan.n, Bm.shape[1]))
        X[plan.perm] = xpad[:plan.n].cpu().numpy()
        return X

    def _solve_f32(self, b: np.ndarray) -> np.ndarray:
        return self._solve_f32_many(np.asarray(b, np.float64)[:, None])[:, 0]

    def solve(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        from ..core.ops import gaxpy, norm1
        if self.pools is None and not self.factor():
            raise ValueError("matrix is singular")
        x = refine(self.A, self._solve_f32, b, iters=refine_iters)
        # numerical singularity on the static-shape path shows up as a
        # residual refinement cannot heal (perturbed pivots, growth):
        # surface it like the reference's cs_lu failure
        b64 = np.asarray(b, np.float64)
        r = b64 - gaxpy(self.A, x, np.zeros_like(b64))
        denom = (norm1(self.A) * np.abs(x).max() + np.abs(b64).max()
                 + 1e-300)
        if not np.isfinite(x).all() or np.abs(r).max() / denom > 1e-6:
            raise ValueError("matrix is singular (refinement diverged)")
        return x

    def solve_host(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        """Host f64 trisolves on the extracted factor (checkpoint /
        debug path: downloads the pools)."""
        if self.pools is None and not self.factor():
            raise ValueError("matrix is singular")
        return refine(self.A, self._solve_f32_host, b, iters=refine_iters)

    def solve_many(self, B: np.ndarray,
                   refine_iters: int = 3) -> np.ndarray:
        """Solve A X = B for (n, k) right-hand sides: one batched device
        solve per sweep + batched f64 refinement (factor once, solve
        many)."""
        B = np.asarray(B, dtype=np.float64)
        if B.ndim == 1:
            return self.solve(B, refine_iters)
        if self.pools is None and not self.factor():
            raise ValueError("matrix is singular")
        return refine_many(self.A, self._solve_f32_many, B, refine_iters)

    def metrics(self) -> Metrics:
        plan = self.plan
        m = Metrics()
        # LU on a symmetric pattern issues ~2x the chol schedule's flops
        m.record(lu_engine="superscan_lu",
                 lu_flops_true=2 * int(plan.flops_true),
                 lu_flops_padded=2 * int(plan.flops_padded),
                 lu_waste_ratio=float(plan.waste_ratio),
                 lu_panels=len(plan.panels),
                 lu_segments=len(plan.segments),
                 lu_levels=int(plan.nlevels),
                 lu_lnz=int(plan.lnz),
                 lu_pivot_tol=self.tol,
                 lu_growth=(float(self.growth)
                            if self.growth is not None else None))
        return m
