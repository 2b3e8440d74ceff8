"""Device one-call solves with the (ok, x) contract of the host engine
(counterparts of ``cholsol``, ``lusol`` and ``qrsol`` in
tpusparse/device/solvers.py).

Host symbolic planning -> f32 factorization on ``device`` -> device
solves -> host f64 iterative refinement.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.matrix import CSCMatrix
from ..core.ops import transpose
from ..numeric.solvers import qrsol as host_qrsol
from .chol_tpu import TpuCholesky
from .lu_tpu import TpuLU
from .mfqr import MultifrontalQR
from .qr_tpu import SparseQR, TpuQR
from .refine import refine
from .superscan import SuperscanCholesky
from .supernodal import SupernodalCholesky

__all__ = ["cholsol", "lusol", "qrsol"]

# "auto" picks superscan from this n up, supernodal below it, as the JAX
# package does
SUPERSCAN_MIN_N = 16384


def cholsol(order: int, A: CSCMatrix, b: np.ndarray, engine: str = None,
            device="cuda"):
    """SPD solve (reference: cs_cholsol).  Returns (ok, x): (False, None)
    on a shape mismatch or when the factorization fails.  ``b`` of n
    entries gives x by the engine's ``solve``; an (n, k) block of
    right-hand sides gives the (n, k) X by its ``solve_many`` (one
    factor, each sweep batched over the k columns, each column refined
    to its own grade).

    ``engine`` (default TPUSPARSE_CHOL_ENGINE, else "auto"): "superscan",
    "supernodal" or "tiled" (the fixed-tile ``TpuCholesky``); "auto" is
    superscan for n >= 16,384 and supernodal below it.  Any other name
    raises ValueError.  A planner or kernel error propagates; it is never
    turned into ok=False.  So the JAX package's chain, where a crashing
    engine falls back to the next (superscan, supernodal, tiled, then
    ok=False), is not ported: it would hide a defect.
    """
    b = np.asarray(b, np.float64)
    if A.m != A.n or b.ndim not in (1, 2) or A.m != b.shape[0]:
        return False, None
    if engine is None:
        engine = os.environ.get("TPUSPARSE_CHOL_ENGINE", "auto")
    if engine == "auto":
        engine = "superscan" if A.n >= SUPERSCAN_MIN_N else "supernodal"
    if engine == "superscan":
        F = SuperscanCholesky(A, order=order if order else 1, device=device)
    elif engine == "supernodal":
        F = SupernodalCholesky(A, order=order if order else 1, device=device)
    elif engine == "tiled":
        F = TpuCholesky(A, order=order, device=device)
    else:
        raise ValueError(f"unknown cholsol engine {engine!r}")
    if not F.factor():
        return False, None
    return True, F.solve_many(b)


def lusol(order: int, A: CSCMatrix, b: np.ndarray, tol: float = 1.0,
          device="cuda"):
    """Square solve (reference: cs_lusol) through ``TpuLU``: BTF, a
    dense LU per small diagonal block, the superscan LU for the large
    ones.  ``tol`` is the threshold-pivoting preference of the sparse
    blocks (within each panel); dense blocks pivot over the whole block.

    Returns (ok, x): (False, None) on a shape mismatch, when the factor
    fails (structural singularity, a zero or non-finite pivot, growth),
    or when refinement does not converge (numerical singularity on the
    perturbed-pivot path).  A planner or kernel error propagates, as in
    ``cholsol``: the JAX package's turning of construction errors into
    ok=False is not ported.
    """
    if A.m != A.n or A.m != len(b):
        return False, None
    F = TpuLU(A, order=order, tol=tol, device=device)
    if not F.factor():
        return False, None
    try:
        return True, F.solve(np.asarray(b, np.float64))
    except (ValueError, FloatingPointError):
        return False, None


QR_ENGINES = ("auto", "mfqr", "csne")


def _sparse_qr_solve(order: int, Atall: CSCMatrix, b: np.ndarray,
                     minnorm: bool, engine: str, device) -> tuple:
    """Sparse solve with the tall ``Atall`` (A, or A' for min-norm):
    the multifrontal Householder QR (true Q) unless ``engine`` is "csne"
    or, under "auto", n exceeds TPUSPARSE_QR_MF_MAX (unset: no ceiling);
    then the Q-less ``SparseQR``, whose condition estimate above
    TPUSPARSE_QR_COND_MAX (default 1e6) returns (None, None): the caller
    takes the host Householder engine."""
    mf_max = int(os.environ.get("TPUSPARSE_QR_MF_MAX", "0")) or None
    if engine == "mfqr" or (engine == "auto" and
                            (mf_max is None or Atall.n <= mf_max)):
        F = MultifrontalQR(Atall, order=order, device=device)
        if not F.factor():
            return False, None
        try:
            return True, (F.solve_minnorm(b) if minnorm else F.solve_ls(b))
        except ValueError as exc:
            if "rank deficient" in str(exc):
                return False, None
            raise
    F = SparseQR(Atall, order=order, device=device)
    if not F.rank_ok:
        return False, None
    cond_max = float(os.environ.get("TPUSPARSE_QR_COND_MAX", "1e6"))
    if F.cond_estimate() > cond_max:
        # Q-less CSNE in f32 is unsafe at this conditioning (augmented
        # refinement stalls beyond ~1/eps_f32)
        return None, None
    return True, (F.solve_minnorm(b) if minnorm else F.solve_ls(b))


def qrsol(order: int, A: CSCMatrix, b: np.ndarray, engine: str = None,
          device="cuda"):
    """Least-squares (m >= n) or minimum-norm (m < n) solve (reference:
    cs_qrsol).  Returns (ok, x): (False, None) on a shape mismatch or a
    rank-deficient factor.

    Up to TPUSPARSE_QR_DENSE_MAX elements m * n (default 2^22) the dense
    ``TpuQR``; above it the sparse route of ``engine`` (default
    TPUSPARSE_QR_ENGINE, else "auto"): "mfqr" the multifrontal QR,
    "csne" the Q-less ``SparseQR`` (whose condition gate hands the
    problem to the host engine, tpusparse_torch.numeric.qrsol), "auto"
    the multifrontal QR up to TPUSPARSE_QR_MF_MAX columns (unset: any),
    else csne.  Any other name raises ValueError.  A planner or kernel
    error propagates, as in ``cholsol``: the JAX package's fallback from
    the multifrontal engine to csne on an exception, and its ok=False on
    any exception, are not ported.
    """
    m, n = A.m, A.n
    b = np.asarray(b, np.float64)
    if len(b) != m:
        return False, None
    if engine is None:
        engine = os.environ.get("TPUSPARSE_QR_ENGINE", "auto")
    if engine not in QR_ENGINES:
        raise ValueError(f"unknown qrsol engine {engine!r}")
    dense_max = int(os.environ.get("TPUSPARSE_QR_DENSE_MAX", str(1 << 22)))
    minnorm = m < n
    Atall = transpose(A, values=True) if minnorm else A
    if m * n > dense_max:
        ok, x = _sparse_qr_solve(order, Atall, b, minnorm, engine, device)
        if ok is None:
            return host_qrsol(order, A, b.copy())
        return ok, x
    F = TpuQR(Atall, order=order, device=device)
    if not F.rank_ok:
        return False, None
    solve = F.solve_minnorm_f32 if minnorm else F.solve_ls_f32
    return True, refine(A, solve, b, iters=2)
