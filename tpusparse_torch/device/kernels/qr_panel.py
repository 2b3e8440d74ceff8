"""Householder QR of one panel of columns for a batch of fronts (H2): the
column loop of the multifrontal QR's front factorization and of the
dense ``TpuQR``.

Computes what the column step of ``qr_factor_partial`` and
``blocked_qr`` in tpusparse/device/dense.py (:239-262) and its compact-WY
``_form_t`` (:167) compute; the JAX package has no Pallas kernel for it
(XLA fuses the column loop).  On a CUDA tensor ``qr_panel`` launches the
hand-written kernel of csrc/qr_panel.cu and adds one to
``qr_panel.launches``; on a CPU tensor it runs the plain version
``qr_panel_ref`` and counts nothing.

The Householder rule is the JAX package's and not LAPACK's: a column
whose part below the diagonal is zero but whose diagonal x0 is not is
still reflected (tau = 2, R = -x0), so ``torch.geqrf`` (tau = 0, R = x0
there) would not reproduce the JAX factors.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, one_device

__all__ = ["qr_panel", "qr_panel_ref"]

MAX_PB = 16


def _check(M: torch.Tensor, taus: torch.Tensor, k0: int,
           pb: int) -> torch.device:
    fn = "qr_panel"
    expect(fn, "M", M, torch.float32, 3)
    expect(fn, "taus", taus, torch.float32, 2)
    P, m, C = M.shape
    if taus.shape != (P, C):
        raise ValueError(f"{fn}: taus {tuple(taus.shape)} for M "
                         f"{tuple(M.shape)}")
    if not (1 <= pb <= MAX_PB and 0 <= k0 < m and k0 + pb <= C):
        raise ValueError(f"{fn}: panel k0={k0} pb={pb} of an (m={m}, "
                         f"C={C}) front (pb in [1, {MAX_PB}])")
    return one_device(fn, M, taus)


def _form_t(V: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Compact-WY T (P, pb, pb) of the reflectors V (P, rows, pb) with
    coefficients tau (P, pb): upper triangular, T[j, j] = tau_j and
    T[:j, j] = -tau_j T[:j, :j] (V^T V)[:j, j] (``_form_t_batched`` of
    the JAX package)."""
    P, _, pb = V.shape
    vtv = torch.bmm(V.transpose(1, 2), V)
    T = torch.zeros((P, pb, pb), dtype=V.dtype, device=V.device)
    for j in range(pb):
        col = torch.bmm(T[:, :j, :j], vtv[:, :j, j, None])[:, :, 0]
        T[:, :j, j] = -tau[:, j, None] * col
        T[:, j, j] = tau[:, j]
    return T


def qr_panel_ref(M: torch.Tensor, taus: torch.Tensor, k0: int,
                 pb: int) -> tuple:
    """Plain version: the JAX column step in torch ops (about 15 a
    column) on rows k0 .. m-1 of the panel, then V and ``_form_t``."""
    P, m, C = M.shape
    X = M[:, k0:, k0:k0 + pb]                  # a view: updates M
    r = torch.arange(m - k0, device=M.device)
    cols = torch.arange(pb, device=M.device)
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    for j in range(pb):
        col = torch.where(r >= j, X[:, :, j], zero)
        normx = torch.sqrt((col * col).sum(1))
        x0 = X[:, j, j]
        alpha = -torch.where(x0 >= 0, one, -one) * normx
        denom = x0 - alpha
        safe = torch.where(denom == 0, one, denom)
        v = torch.where(r > j, col / safe[:, None], zero)
        v[:, j] = 1.0
        tau = torch.where(normx == 0, zero,
                          (alpha - x0) / torch.where(alpha == 0, one, alpha))
        taus[:, k0 + j] = tau
        w = torch.bmm(v[:, None, :], X)[:, 0]
        w = torch.where(cols >= j, w, zero)
        X -= (tau[:, None] * v)[:, :, None] * w[:, None, :]
        X[:, :, j] = torch.where(r > j, v, X[:, :, j])
    V = torch.where(r[:, None] > cols, X, zero) + (r[:, None] == cols).to(
        M.dtype)
    return V, _form_t(V, taus[:, k0:k0 + pb])


def qr_panel(M: torch.Tensor, taus: torch.Tensor, k0: int, pb: int) -> tuple:
    """In place, columns [k0, k0 + pb) of each (m, C) front of the
    contiguous f32 M (P, m, C) become the panel's reflectors (below the
    diagonal) and R (on and above it), taus[:, k0:k0 + pb] their
    coefficients; 1 <= pb <= 16.  Returns (V, T): V (P, m - k0, pb) the
    unit lower-trapezoidal reflectors from row k0 on, T (P, pb, pb) the
    compact-WY factor, so that the panel's Q is I - V T V^T."""
    dev = _check(M, taus, k0, pb)
    if dev.type == "cpu":
        return qr_panel_ref(M, taus, k0, pb)
    P, m, C = M.shape
    V = torch.empty((P, m - k0, pb), dtype=M.dtype, device=dev)
    T = torch.empty((P, pb, pb), dtype=M.dtype, device=dev)
    if P == 0:
        return V, T
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.tpt_qr_panel(M.data_ptr(), taus.data_ptr(),
                                  V.data_ptr(), T.data_ptr(), P, m, C, k0,
                                  pb, stream), "tpt_qr_panel")
    qr_panel.launches += 1
    return V, T


qr_panel.launches = 0
