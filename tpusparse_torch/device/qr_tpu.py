"""Device QR: blocked Householder (compact-WY) on the AMD-permuted,
padded dense matrix, and the Q-less sparse path (counterpart of
tpusparse/device/qr_tpu.py).  Reference: csparse::cs_qr (SURVEY.md
§3.3).

* ``TpuQR``: the dense path for problems of up to TPUSPARSE_QR_DENSE_MAX
  elements (device.solvers.qrsol): panels of 16 reflectors by the panel
  kernel (H2), trailing updates as batched products, Q^T b and Q y by
  the reflector kernel (H3).  Padding columns get unit diagonals in
  otherwise zero rows, so R stays nonsingular and the padded solution
  components are exactly zero.
* ``SparseQR``: Q-less QR of a tall sparse matrix: R is the superscan
  Cholesky factor of A'A (order 1, so the chol and trsm tile kernels),
  Q is never formed.  Solves are device-resident and refined on the
  augmented system; ``cond_estimate`` gates the route in qrsol.

Least-squares (m >= n) and minimum-norm (m < n, factor A') solves follow
cs_qrsol, wrapped in f64 refinement.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import CSCMatrix
from ..core.ops import gaxpy, multiply, norm1, transpose
from ..symbolic.amd import amd
from .config import round_up
from .dense import (blocked_qr, qr_apply_q, qr_apply_qt, qr_solve_r,
                    qr_solve_rt)
from .superscan import SuperscanCholesky

__all__ = ["TpuQR", "SparseQR"]


class SparseQR:
    """Q-less supernodal QR of a tall sparse matrix (m >= n): R via the
    superscan Cholesky of A'A (the reference's cs_sqr column-etree
    analysis drives the same planner); Q is never formed.

    * solves run against the factor pools on the device
      (``SuperscanCholesky._solve_f32``); the factor is never downloaded;
    * least-squares and min-norm solves refine on the augmented system
      [[I, A], [A', 0]] [r; x] = [b; 0] (Bjorck 1967), contracting at
      ~kappa(A) eps per iteration, not the kappa^2 eps of plain CSNE;
      ``last_info`` reports the true and the normal-equation residuals;
    * ``cond_estimate()`` bounds kappa_2(A) by power iteration.

    ``device`` defaults to "cuda" and raises without a card.
    """

    def __init__(self, A: CSCMatrix, order: int = 3, device="cuda",
                 **superscan_kw):
        if A.m < A.n:
            raise ValueError("m >= n required (caller factors A')")
        self.A = A
        self.At = transpose(A, values=True)
        self.AtA = multiply(self.At, A)
        self.F = SuperscanCholesky(self.AtA, order=1, device=device,
                                   **superscan_kw)
        # rank detection: the Cholesky of A'A fails iff A is
        # (numerically) rank-deficient at f32 grade
        self.rank_ok = self.F.factor()
        self.last_info = {}

    @property
    def plan(self):
        return self.F.plan

    def _rtr_solve(self, rhs: np.ndarray) -> np.ndarray:
        """One f32 device-resident solve of R'R y = rhs."""
        return self.F._solve_f32(rhs)

    def _mv(self, M: CSCMatrix, v: np.ndarray) -> np.ndarray:
        return gaxpy(M, np.asarray(v, np.float64), np.zeros(M.m))

    def solve_ls(self, b: np.ndarray, refine_iters: int = 8,
                 rtol: float = 1e-14) -> np.ndarray:
        """min ||A x - b|| via augmented-system refinement: state
        (x, r) with r the LS residual; each step solves R'R dx =
        A'(b - r - A x) + A'r on device and updates both."""
        if not self.rank_ok:
            raise ValueError("rank deficient")
        b = np.asarray(b, np.float64)
        n = self.A.n
        x = np.zeros(n)
        r = np.zeros(self.A.m)
        nrmA = norm1(self.A)
        ne = true = np.inf
        for it in range(refine_iters):
            f1 = b - r - self._mv(self.A, x)       # b - r - A x
            f2 = -self._mv(self.At, r)             # -(A' r)
            rhs = self._mv(self.At, f1) - f2
            ne = np.abs(rhs).max() / max(
                nrmA * (nrmA * np.abs(x).max() + np.abs(b).max()),
                1e-300)
            scale = nrmA * np.abs(x).max() + np.abs(b).max()
            true = np.abs(f1).max() / max(scale, 1e-300)
            if max(ne, true) < rtol:
                break
            dx = self._rtr_solve(rhs)
            dr = f1 - self._mv(self.A, dx)
            x = x + dx
            r = r + dr
        self.last_info = {"iters": it + 1, "ne_resid": float(ne),
                          "aug_resid": float(true)}
        return x

    def solve_minnorm(self, b: np.ndarray, refine_iters: int = 8,
                      rtol: float = 1e-14) -> np.ndarray:
        """This object factors B = A_orig' (tall, n x m); min-norm
        solution of A_orig x = b.  Augmented state (x, lam) with
        x = B lam: each step solves B'B dlam = (b - B'x) - B'(B lam - x)
        on device."""
        if not self.rank_ok:
            raise ValueError("rank deficient")
        b = np.asarray(b, np.float64)
        B = self.A                                  # = A_orig'
        x = np.zeros(B.m)
        lam = np.zeros(B.n)
        nrmB = norm1(B)
        eq = np.inf
        for it in range(refine_iters):
            f1 = self._mv(B, lam) - x               # B lam - x
            f2 = b - self._mv(self.At, x)           # b - A_orig x
            eq = np.abs(f2).max() / max(
                nrmB * np.abs(x).max() + np.abs(b).max(), 1e-300)
            if eq < rtol and np.abs(f1).max() < rtol * max(
                    np.abs(x).max(), 1.0):
                break
            rhs = f2 - self._mv(self.At, f1)
            dlam = self._rtr_solve(rhs)
            dx = f1 + self._mv(B, dlam)
            x = x + dx
            lam = lam + dlam
        self.last_info = {"iters": it + 1, "eq_resid": float(eq)}
        return x

    def cond_estimate(self, iters: int = 8, seed: int = 0) -> float:
        """kappa_2(A) estimate: sigma_max^2 by power iteration on A'A,
        sigma_min^2 by inverse power iteration via the device R'R
        solve.  A few iterations give an order-of-magnitude bound:
        enough to gate the Q-less path."""
        n = self.A.n
        if n == 0 or not self.rank_ok:
            return np.inf
        rng = np.random.default_rng(seed)
        v = rng.normal(size=n)
        v /= np.linalg.norm(v)
        hi = 0.0
        for _ in range(iters):
            w = self._mv(self.At, self._mv(self.A, v))
            hi = float(np.linalg.norm(w))
            if hi == 0:
                return np.inf
            v = w / hi
        u = rng.normal(size=n)
        u /= np.linalg.norm(u)
        inv = 0.0
        for _ in range(iters):
            w = self._rtr_solve(u)
            nw = float(np.linalg.norm(w))
            if not np.isfinite(nw) or nw == 0:
                return np.inf
            inv = nw
            u = w / nw
        # hi ~ sigma_max^2, inv ~ 1/sigma_min^2
        return float(np.sqrt(hi * inv))


class TpuQR:
    """Dense QR of a (tall) sparse matrix on ``device`` (default "cuda";
    raises without a card): A(:, q), q = amd(order), densified and padded
    to (mpad, npad), factored by ``blocked_qr`` with panels of ``bs``."""

    def __init__(self, A: CSCMatrix, order: int = 3, bs: int = 16,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TpuQR: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if A.m < A.n:
            raise ValueError("m >= n required (caller factors A')")
        m, n = A.m, A.n
        self.A = A
        self.q = amd(order, A)
        npad = max(round_up(n, bs), bs)
        mpad = round_up(max(m + (npad - n), npad), 8)
        self.m, self.n = m, n
        self.mpad, self.npad = mpad, npad
        self.bs = bs
        dense = np.zeros((mpad, npad), dtype=np.float32)
        cols = self.q if self.q is not None else np.arange(n)
        for jj, col in enumerate(cols):
            seg = slice(A.indptr[col], A.indptr[col + 1])
            dense[A.indices[seg], jj] = A.data[seg]
        for t in range(n, npad):                 # unit pad columns in
            dense[m + (t - n), t] = 1.0          # otherwise-zero rows
        self.VR, self.taus = blocked_qr(
            torch.from_numpy(dense).to(self.device), bs)
        Rdiag = torch.diagonal(self.VR)[:n].abs()
        self.rank_ok = bool(torch.stack([
            (Rdiag > 0).all(), torch.isfinite(self.VR).all()]).all())

    def _vec(self, v: np.ndarray, size: int) -> torch.Tensor:
        pad = np.zeros(size, dtype=np.float32)
        pad[:len(v)] = v
        return torch.from_numpy(pad).to(self.device)

    def qt_apply(self, b: np.ndarray) -> np.ndarray:
        return qr_apply_qt(self.VR, self.taus,
                           self._vec(b, self.mpad)).cpu().numpy()

    def solve_ls_f32(self, b: np.ndarray) -> np.ndarray:
        """min ||A x - b||: x = R^-1 (Q' b)[:n], column perm undone."""
        qtb = qr_apply_qt(self.VR, self.taus, self._vec(b, self.mpad))
        xp = qr_solve_r(self.VR, qtb).cpu().numpy().astype(
            np.float64)[:self.n]
        x = np.zeros(self.n, dtype=np.float64)
        cols = self.q if self.q is not None else np.arange(self.n)
        x[cols] = xp
        return x

    def solve_minnorm_f32(self, b: np.ndarray) -> np.ndarray:
        """This object factors B = A_orig' (tall); the min-norm solution
        of A_orig x = b is x = Q (R'^-1 (b with B's column perm
        applied))."""
        cols = self.q if self.q is not None else np.arange(self.n)
        bp = np.asarray(b, np.float64)[cols]
        z = qr_solve_rt(self.VR, self._vec(bp, self.npad))
        zfull = torch.zeros(self.mpad, device=self.device)
        zfull[:z.shape[0]] = z
        x = qr_apply_q(self.VR, self.taus, zfull).cpu().numpy()
        return x.astype(np.float64)[:self.m]
