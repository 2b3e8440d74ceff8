"""Block-tiled right-looking Cholesky in PyTorch: factor, solve and
rank-1 update/downdate of the fixed-tile engine.

Port of the device half of tpusparse/device/chol_tpu.py.  The plan is
the JAX package's, made by the numpy planner copied into ``chol_plan``;
its per-panel index lists are uploaded once, at first use (int64, on the
factor's device).  Tiles live in one (T, B, B) pool, updated in
place (``index_copy_``, ``index_add_``) where JAX rebuilt it
functionally.

Factor: a host loop over the nb panels (JAX: ``_factor_fn``, or the
``lax.scan`` of ``_scan_factor_generic``).  Per panel: the diagonal
tile's Cholesky by ``kernels.chol_tiles`` (B1), a gather of the panel's
off-diagonal tiles, ``kernels.trsm_tiles`` (B3) against the one diagonal
factor, written back, one ``bmm`` for the La @ Lb^T updates and an
``index_add_`` of them into their target tiles.  A panel with no
off-diagonal tiles stops after its diagonal.  A tile that is not
positive definite comes out of B1 as NaN; the one host sync is the
finiteness check of the diagonal tiles at the end.

Solve: forward then backward block substitution per panel in f32, all
k right-hand sides at once as an (nb, B, k) tensor (JAX vmaps over
them), then host f64 iterative refinement.

Updown: the alpha/beta/gamma recurrence of cs_updown over all n columns
(JAX: one ``lax.scan``), here a host loop with the pool flat on the
device plus one dump entry; the ``ok`` flag stays on the device and is
read once, and a failed downdate keeps the old pool.

Left out of the JAX module, because they only reuse compiled programs
and change no result: ``use_scan``/``SCAN_THRESHOLD``, ``_SCAN_CACHE``,
the power-of-two schedule padding with its dump and identity tiles
(``_pad_schedule``, ``_factor_fn_scan``, ``_solve_fn_scan``) and
``_UD_JIT``.  ``metrics()`` waits for a port of utils/profiling.

Block size: the kernels take tiles of B a multiple of 8 in [8, 128], on
the card and (by the same argument checks) on the CPU, so the
constructor raises ValueError for any other B before it touches the
device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.matrix import CSCMatrix, csc_from_dense
from ..core.ops import add, multiply, transpose

from .chol_plan import CholPlan, plan_cholesky
from .config import DTYPE, IDX_DTYPE
from .kernels import chol_tiles, trsm_tiles
from .refine import refine
from .refine_many import refine_many

__all__ = ["TpuCholesky", "CholPlan", "plan_cholesky", "pool_from_numpy",
           "pool_to_numpy"]

_MAX_B = 128


def pool_from_numpy(pool: np.ndarray, device) -> torch.Tensor:
    """Copy a host (T, B, B) tile pool to ``device`` as f32; never shares
    memory with the array."""
    return torch.tensor(np.asarray(pool), dtype=DTYPE, device=device)


def pool_to_numpy(pool: torch.Tensor) -> np.ndarray:
    return pool.detach().cpu().numpy()


def _check_block(B: int) -> None:
    if B % 8 or not 8 <= B <= _MAX_B:
        raise ValueError(f"TpuCholesky: block {B} is outside the range of "
                         f"the chol and trsm tile kernels (a multiple of 8 "
                         f"in [8, {_MAX_B}])")


class _Sched:
    """The plan's per-panel index lists, packed into one host buffer and
    uploaded as one int64 tensor; ``panels[k]`` holds panel k's views
    (off_ids, off_rows, upd_dst, upd_a, upd_b), None where it has no
    off-diagonal tiles."""

    NAMES = ("off_ids", "off_rows", "upd_dst", "upd_a", "upd_b")

    def __init__(self, plan: CholPlan, device):
        lists = [getattr(plan, nm) for nm in self.NAMES]
        flat = np.concatenate([a for per in zip(*lists) for a in per]
                              + [np.zeros(0, np.int64)])
        dev = torch.from_numpy(flat).to(device).to(IDX_DTYPE)
        self.panels: List[Optional[tuple]] = []
        off = 0
        for k in range(plan.nb):
            views = []
            for a in (lst[k] for lst in lists):
                views.append(dev[off:off + a.size])
                off += a.size
            self.panels.append(tuple(views) if plan.off_ids[k].size
                               else None)


def _factor(plan: CholPlan, pool: torch.Tensor, sched: _Sched
            ) -> torch.Tensor:
    """Factor ``pool`` (the plan's initial tiles, on their device) in
    place and return it (JAX: chol_tpu.py:419-447)."""
    for k in range(plan.nb):
        dk = int(plan.diag_id[k])
        Lkk = chol_tiles(pool[dk:dk + 1])[0]
        pool[dk] = Lkk
        idx = sched.panels[k]
        if idx is None:
            continue
        off_ids, _, upd_dst, upd_a, upd_b = idx
        Y = trsm_tiles(Lkk, pool[off_ids])                 # (r, B, B)
        pool.index_copy_(0, off_ids, Y)
        if upd_dst.numel():
            delta = torch.bmm(Y[upd_a], Y[upd_b].mT)       # (u, B, B)
            pool.index_add_(0, upd_dst, delta, alpha=-1)
    return pool


def _solve(plan: CholPlan, pool: torch.Tensor, sched: _Sched,
           bt: torch.Tensor) -> torch.Tensor:
    """L L' X = B on the factored pool, in place on ``bt`` (nb, B, k):
    forward, then backward block substitution (JAX: chol_tpu.py:450-485,
    vmapped over the k columns)."""
    nb, B = plan.nb, plan.B
    k = bt.shape[2]
    for p in range(nb):
        Lkk = pool[int(plan.diag_id[p])]
        xk = torch.linalg.solve_triangular(Lkk, bt[p], upper=False)
        bt[p] = xk
        idx = sched.panels[p]
        if idx is not None:
            off_ids, off_rows = idx[:2]
            delta = torch.matmul(pool[off_ids], xk)        # (r, B, k)
            bt.index_add_(0, off_rows, delta, alpha=-1)
    for p in range(nb - 1, -1, -1):
        acc = bt[p]
        idx = sched.panels[p]
        if idx is not None:
            off_ids, off_rows = idx[:2]
            blocks = pool[off_ids].reshape(-1, B)          # (r*B, B)
            acc = acc - blocks.mT @ bt[off_rows].reshape(-1, k)
        Lkk = pool[int(plan.diag_id[p])]
        bt[p] = torch.linalg.solve_triangular(Lkk.mT, acc, upper=True)
    return bt


class TpuCholesky:
    """Plan, factor and solve of the fixed-tile engine (same
    contracts as the JAX ``TpuCholesky``): f32 factor on ``device``, f64
    refined solves, device-resident rank-1 update/downdate.

    ``device`` defaults to "cuda", so a machine without a card fails here
    instead of running on the CPU; the CPU runs the plain versions of the
    kernels."""

    def __init__(self, A: CSCMatrix, order: int = 1,
                 block: Optional[int] = None, device="cuda"):
        self.device = torch.device(device)
        self.A = A
        self.plan = plan_cholesky(A, order=order, block=block)
        _check_block(self.plan.B)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TpuCholesky: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self.pool: Optional[torch.Tensor] = None
        self._sched: Optional[_Sched] = None
        self._ud_sched = None

    def load_pool(self, pool: np.ndarray) -> None:
        """Take a factored (or initial) pool from the host, e.g. the JAX
        package's ``np.asarray(F.pool)``."""
        self.pool = pool_from_numpy(pool, self.device)

    def factor(self) -> bool:
        plan = self.plan
        if self._sched is None:
            self._sched = _Sched(plan, self.device)
        pool = _factor(plan, pool_from_numpy(plan.pool_init, self.device),
                       self._sched)
        # the one host sync: non-SPD -> NaN in a diagonal tile
        diag = torch.from_numpy(plan.diag_id).to(self.device)
        ok = bool(torch.isfinite(pool[diag]).all())
        if ok:
            self.pool = pool
        return ok

    def _solve_f32_many(self, Bm: np.ndarray) -> np.ndarray:
        """f32 device solve of (n, k) right-hand sides, one pass of the
        block substitution for all k."""
        plan = self.plan
        nb, Bsz, n = plan.nb, plan.B, plan.n
        k = Bm.shape[1]
        if self._sched is None:
            self._sched = _Sched(plan, self.device)
        Bp = Bm[plan.perm] if plan.perm is not None else Bm
        bt = np.zeros((nb * Bsz, k), dtype=np.float32)
        bt[:n] = Bp
        xt = _solve(plan, self.pool, self._sched,
                    torch.from_numpy(bt.reshape(nb, Bsz, k)).to(self.device))
        Xp = xt.reshape(-1, k)[:n].cpu().numpy().astype(np.float64)
        if plan.perm is not None:
            out = np.zeros_like(Xp)
            out[plan.perm] = Xp
            return out
        return Xp

    def _solve_f32(self, b: np.ndarray) -> np.ndarray:
        return self._solve_f32_many(np.asarray(b, np.float64)[:, None])[:, 0]

    def solve(self, b: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        """Solve A x = b: f32 device solves + f64 host iterative
        refinement to reference-grade residuals."""
        if self.pool is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        return refine(self.A, self._solve_f32, b, iters=refine_iters)

    def solve_many(self, B: np.ndarray, refine_iters: int = 3) -> np.ndarray:
        """Solve A X = B for (n, k) right-hand sides: batched device
        solves + batched f64 refinement (factor once, solve many)."""
        B = np.asarray(B, dtype=np.float64)
        if B.ndim == 1:
            return self.solve(B, refine_iters)
        if self.pool is None and not self.factor():
            raise ValueError("matrix is not positive definite")
        return refine_many(self.A, self._solve_f32_many, B, refine_iters)

    # ------------------------------------------------------------ updown
    def _extract_L(self):
        """Reconstruct the factor as host CSC (permuted coordinates,
        diagonal-first columns, INCLUDING stored padding zeros so the
        tile pattern round-trips) plus the entry -> tile-slot map."""
        plan = self.plan
        nb, B, n = plan.nb, plan.B, plan.n
        pool = pool_to_numpy(self.pool).astype(np.float64)
        cols_entries = [[] for _ in range(n)]     # (row, val, slot, r, c)
        for k in range(nb):
            dt = pool[plan.diag_id[k]]
            base = k * B
            for c in range(min(B, n - base)):
                j = base + c
                for r in range(c, min(B, n - base)):
                    cols_entries[j].append(
                        (base + r, dt[r, c], int(plan.diag_id[k]), r, c))
            for I, sid in zip(plan.off_rows[k], plan.off_ids[k]):
                ot = pool[sid]
                rbase = int(I) * B
                for c in range(min(B, n - base)):
                    j = base + c
                    for r in range(min(B, n - rbase)):
                        cols_entries[j].append(
                            (rbase + r, ot[r, c], int(sid), r, c))
        indptr = np.zeros(n + 1, dtype=np.int64)
        rows, vals, slots = [], [], []
        for j in range(n):
            ent = sorted(cols_entries[j])          # diag first (row order)
            indptr[j + 1] = indptr[j] + len(ent)
            for row, v, sid, r, c in ent:
                rows.append(row)
                vals.append(v)
                slots.append((sid, r, c))
        L = CSCMatrix(n, n, indptr, np.asarray(rows, np.int64),
                      np.asarray(vals))
        return L, slots

    def _updown_sched(self):
        """Static per-column schedule of the updown loop (JAX:
        chol_tpu.py:641-678): for every column j, the flat pool index of
        L(j, j) (``dflat``, kept on the host: the loop reads it as Python
        ints), and the flat pool indices of its stored entries below the
        diagonal with their global rows (``colidx``, ``rowid``, (n, H),
        on the device; padding points at the dump entry and the dump row
        n).  Built once per plan."""
        if self._ud_sched is not None:
            return self._ud_sched
        plan = self.plan
        n, B, nb = plan.n, plan.B, plan.nb
        T = plan.pool_init.shape[0]
        maxoff = max((x.size for x in plan.off_ids), default=0)
        H = max((B - 1) + maxoff * B, 1)
        dump_flat = T * B * B                     # one appended entry
        dflat = np.zeros(n, np.int64)
        colidx = np.full((n, H), dump_flat, np.int64)
        rowid = np.full((n, H), n, np.int64)
        for jb in range(nb):
            dslot = int(plan.diag_id[jb])
            offs = plan.off_ids[jb]
            rows = plan.off_rows[jb]
            for c in range(min(B, n - jb * B)):
                j = jb * B + c
                dflat[j] = (dslot * B + c) * B + c
                r = np.arange(c + 1, B)
                colidx[j, :r.size] = (dslot * B + r) * B + c
                rowid[j, :r.size] = np.minimum(jb * B + r, n)
                q = r.size
                for I, slot in zip(rows, offs):
                    rr = np.arange(B)
                    colidx[j, q:q + B] = (int(slot) * B + rr) * B + c
                    rowid[j, q:q + B] = np.minimum(int(I) * B + rr, n)
                    q += B
        self._ud_sched = (dflat, torch.from_numpy(colidx).to(self.device),
                          torch.from_numpy(rowid).to(self.device))
        return self._ud_sched

    def updown(self, sigma: int, w: np.ndarray) -> bool:
        """Rank-1 update/downdate of the factored pool: A <- A + sigma*w*w'
        (reference: csparse::cs_updown).

        w is in original coordinates; its pattern must be contained in an
        existing column pattern of L (the reference demo3 contract).  The
        factor never leaves the device; on a failed downdate (not
        positive definite) the old pool is kept and False returned."""
        if self.pool is None:
            raise ValueError("factor() first")
        plan = self.plan
        w = np.asarray(w, dtype=np.float64)
        wp = w[plan.perm] if plan.perm is not None else w.copy()
        dflat, colidx, rowid = self._updown_sched()
        poolf = torch.cat([self.pool.reshape(-1), self.pool.new_zeros(1)])
        wt = torch.from_numpy(np.concatenate([wp, [0.0]]).astype(
            np.float32)).to(self.device)
        ok = _updown(poolf, wt, dflat, colidx, rowid, 1 if sigma > 0 else -1)
        if not bool(ok):
            return False
        self.pool = poolf[:-1].view(self.pool.shape)
        W = csc_from_dense(w.reshape(-1, 1))
        self.A = add(self.A, multiply(W, transpose(W)), 1.0, float(sigma))
        return True


def _updown(poolf: torch.Tensor, w: torch.Tensor, dflat: np.ndarray,
            colidx: torch.Tensor, rowid: torch.Tensor,
            sigma: int) -> torch.Tensor:
    """The cs_updown recurrence over every column, in place on the flat
    pool ``poolf`` (last entry: dump) and on ``w`` (last entry: dump row,
    kept at 0); returns the device flag "no beta^2 <= 0 met" (JAX:
    ``_updown_scan``, chol_tpu.py:681-722).  Where w is zero a column is
    an exact no-op, so the loop never depends on the data."""
    n = w.shape[0] - 1
    beta = torch.ones((), dtype=DTYPE, device=w.device)
    ok = torch.ones((), dtype=torch.bool, device=w.device)
    for j in range(n):
        df = int(dflat[j])
        ci, ri = colidx[j], rowid[j]
        Ljj, wj = poolf[df], w[j]
        alpha = wj / Ljj
        beta2sq = beta * beta + sigma * alpha * alpha
        ok = ok & ~(beta2sq <= 0.0)
        beta2 = beta2sq.clamp(min=1e-30).sqrt()
        delta = beta / beta2 if sigma > 0 else beta2 / beta
        gamma = sigma * alpha / (beta2 * beta)
        poolf[df] = delta * Ljj + gamma * wj if sigma > 0 else delta * Ljj
        Lcol = poolf[ci]
        w1 = w[ri]
        w2 = w1 - alpha * Lcol
        w.index_copy_(0, ri, w2)
        w[n] = 0.0                          # keep the dump row clean
        poolf.index_copy_(0, ci, delta * Lcol
                          + gamma * (w1 if sigma > 0 else w2))
        beta = beta2
    return ok
