"""Dense blocked factorizations on a device (counterpart of
tpusparse/device/dense.py).

LU, the diagonal blocks of ``TpuLU`` (``blocked_lu`` and ``lu_solve``,
:37-95): jnp code with no Pallas kernel, ported as the supernodal
engine's dense blocks are, onto the library's getrf and triangular
solves.  Both the reference and getrf pick, in each column, the first row
with the largest |candidate| over all remaining rows, and leave a column
whose candidates are all zero unscaled with a zero on the diagonal, so
the factors agree up to rounding.

QR (:100-475), the fronts of ``MultifrontalQR`` and the dense ``TpuQR``:
blocked Householder with compact-WY accumulation, batched over fronts.
Each panel of at most ``bs`` columns is factored by the hand-written
panel kernel (``kernels.qr_panel``, H2), which keeps the JAX package's
Householder rule (not geqrf's: see that module), and the rest of the
front is updated as rest -= V (T^T (V^T rest)) in three batched
products.  Reflectors are applied to vectors by ``kernels.qr_apply``
(H3), in compact-WY panels of 8.  Only the narrowed (``_partial``) form is
ported: the JAX package's scan forms (``qr_factor_scan``,
``qr_qt_mul_scan``, ``qr_q_mul_scan``) bound the size of its compiled
programs and give the same outputs up to reassociation.
"""

from __future__ import annotations

import torch

from .kernels import qr_apply, qr_panel

__all__ = ["blocked_lu", "lu_solve", "blocked_qr", "qr_apply_qt",
           "qr_apply_q", "qr_solve_r", "qr_solve_rt", "qr_factor_partial",
           "qr_qt_mul_batched", "qr_q_mul_batched"]


def blocked_lu(M: torch.Tensor) -> tuple:
    """LU with partial pivoting of the square padded M (the reference's
    panel width ``bs`` does not enter: getrf blocks by its own).

    Returns (LU, perm): LU holds unit-lower L below the diagonal and U on
    and above it; perm is the pivot row permutation (row i of PA is row
    perm[i] of A), on M's device and made there, with no host sync.
    """
    LU, piv, _ = torch.linalg.lu_factor_ex(M)
    # M = P L U, so row i of L U is row perm[i] of M: P[perm[i], i] = 1
    P, _, _ = torch.lu_unpack(LU, piv, unpack_data=False)
    return LU, P.argmax(dim=0)


def lu_solve(LU: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given blocked_lu's output."""
    pb = b[perm][:, None]
    y = torch.linalg.solve_triangular(LU, pb, upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[:, 0]


# -------------------------------------------------------------------- QR
def _panel_starts(kelim: int, bs: int) -> list:
    """(k0, width) pairs covering [0, kelim): the last panel may be
    narrower than bs (bucket sizes are multiples of 4, not of bs)."""
    return [(k0, min(bs, kelim - k0)) for k0 in range(0, kelim, bs)]


def qr_factor_partial(M: torch.Tensor, taus: torch.Tensor, bs: int,
                      kelim: int) -> None:
    """In place, blocked Householder QR of a batch of padded fronts M
    (P, m, n), eliminating the first ``kelim`` columns: V below the
    diagonal (unit diagonal implied), R on and above it, the
    coefficients in taus (P, n).  Zero-padded rows and columns give
    tau = 0 reflectors (the identity)."""
    n = M.shape[2]
    for k0, pb in _panel_starts(kelim, bs):
        V, T = qr_panel(M, taus, k0, pb)
        if k0 + pb < n:
            rest = M[:, k0:, k0 + pb:]          # rows above k0: V is 0
            W = torch.bmm(V.transpose(1, 2), rest)
            rest.baddbmm_(V, torch.bmm(T.transpose(1, 2), W), alpha=-1.0)


def blocked_qr(M: torch.Tensor, bs: int) -> tuple:
    """Blocked Householder QR of the padded M (m x n, n divisible by bs,
    m >= n).  Returns (VR, taus): VR holds the reflectors below the
    diagonal and R on and above it."""
    m, n = M.shape
    VR = M.clone()[None]
    taus = torch.zeros((1, n), dtype=M.dtype, device=M.device)
    qr_factor_partial(VR, taus, bs, n)
    return VR[0], taus[0]


def _apply1(VR: torch.Tensor, taus: torch.Tensor, b: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    z = b.clone()[None]
    slots = torch.zeros(1, dtype=torch.int64, device=b.device)
    qr_apply(VR[None], taus[None], slots, z, min(VR.shape), transpose)
    return z[0]


def qr_apply_qt(VR: torch.Tensor, taus: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Q^T b (H_0 applied first) for blocked_qr's output."""
    return _apply1(VR, taus, b, True)


def qr_apply_q(VR: torch.Tensor, taus: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Q b (H_{n-1} applied first) for blocked_qr's output."""
    return _apply1(VR, taus, b, False)


def _batch(VR: torch.Tensor, taus: torch.Tensor, z: torch.Tensor,
           kelim: int, transpose: bool) -> torch.Tensor:
    z = z.clone()
    slots = torch.arange(VR.shape[0], device=VR.device)
    qr_apply(VR.contiguous(), taus.contiguous(), slots, z, kelim, transpose)
    return z


def qr_qt_mul_batched(VR: torch.Tensor, taus: torch.Tensor,
                      z: torch.Tensor, kelim: int) -> torch.Tensor:
    """Q^T z for a batch of factored fronts: VR (P, m, n), taus (P, n),
    z (P, m); the first ``kelim`` reflectors, H_0 first."""
    return _batch(VR, taus, z, kelim, True)


def qr_q_mul_batched(VR: torch.Tensor, taus: torch.Tensor,
                     z: torch.Tensor, kelim: int) -> torch.Tensor:
    """Q z for a batch of factored fronts (the last reflector first)."""
    return _batch(VR, taus, z, kelim, False)


def qr_solve_r(VR: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x = R \\ y[:n] on the padded factor."""
    n = VR.shape[1]
    R = torch.triu(VR[:n, :])
    return torch.linalg.solve_triangular(R, y[:n, None], upper=True)[:, 0]


def qr_solve_rt(VR: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x = R^T \\ y[:n] (for the min-norm path)."""
    n = VR.shape[1]
    R = torch.triu(VR[:n, :])
    return torch.linalg.solve_triangular(R.T, y[:n, None],
                                         upper=False)[:, 0]
