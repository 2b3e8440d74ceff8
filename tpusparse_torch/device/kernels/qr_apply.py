"""Application of factored fronts' Householder reflectors to one vector
per front (H3): the front work of the multifrontal QR's Q^T and Q passes
and of the dense ``TpuQR``'s Q^T b and Q y.

Computes, up to rounding, what the compact-WY applications of
tpusparse/device/dense.py compute (``qr_qt_mul_batched`` :303,
``qr_q_mul_batched`` :319, the dense ``qr_apply_qt`` / ``qr_apply_q``
:183, :197); the JAX package has no Pallas kernel for them (XLA fuses
the einsums).  On a CUDA tensor ``qr_apply`` launches the hand-written
kernel of csrc/qr_apply.cu and adds one to ``qr_apply.launches``; on a
CPU tensor it runs the plain version ``qr_apply_ref`` and counts
nothing.
"""

from __future__ import annotations

import torch

from . import _build
from ._args import expect, one_device

__all__ = ["qr_apply", "qr_apply_ref"]


def _check(pool: torch.Tensor, taus: torch.Tensor, slots: torch.Tensor,
           z: torch.Tensor, kelim: int) -> torch.device:
    fn = "qr_apply"
    expect(fn, "pool", pool, torch.float32, 3)
    expect(fn, "taus", taus, torch.float32, 2)
    expect(fn, "slots", slots, torch.int64, 1)
    expect(fn, "z", z, torch.float32, 2)
    S, Rh, C = pool.shape
    if taus.shape != (S, C) or z.shape != (S, Rh):
        raise ValueError(f"{fn}: pool {tuple(pool.shape)}, taus "
                         f"{tuple(taus.shape)}, z {tuple(z.shape)}")
    if not 0 <= kelim <= min(Rh, C):
        raise ValueError(f"{fn}: kelim {kelim} for ({Rh}, {C}) fronts")
    return one_device(fn, pool, taus, slots, z)


def qr_apply_ref(pool: torch.Tensor, taus: torch.Tensor,
                 slots: torch.Tensor, z: torch.Tensor, kelim: int,
                 transpose: bool) -> None:
    """Plain version: the kernel's reflector loop in torch ops, batched
    over the fronts (about 8 ops a reflector)."""
    F = pool[slots]
    t = taus[slots]
    zb = z[slots]
    order = range(kelim) if transpose else range(kelim - 1, -1, -1)
    for k in order:
        v = F[:, k:, k].clone()
        v[:, 0] = 1.0
        td = t[:, k] * (v * zb[:, k:]).sum(1)
        zb[:, k:] -= td[:, None] * v
    z[slots] = zb


def qr_apply(pool: torch.Tensor, taus: torch.Tensor, slots: torch.Tensor,
             z: torch.Tensor, kelim: int, transpose: bool) -> None:
    """In place, for each p with s = slots[p]: z[s] <- Q^T z[s]
    (``transpose``: H_0 first) or Q z[s] (H_{kelim-1} first), Q the
    product of the first ``kelim`` reflectors of the factored front
    pool[s] (reflector k below the diagonal of column k, unit diagonal
    implied) with coefficients taus[s].  pool (S, Rh, C), taus (S, C), z
    (S, Rh) f32 and slots (P,) int64 (distinct), contiguous."""
    dev = _check(pool, taus, slots, z, kelim)
    if dev.type == "cpu":
        qr_apply_ref(pool, taus, slots, z, kelim, transpose)
        return
    P = slots.shape[0]
    if P == 0 or kelim == 0:
        return
    S, Rh, C = pool.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(lib.tpt_qr_apply(pool.data_ptr(), taus.data_ptr(),
                                  slots.data_ptr(), z.data_ptr(), P, Rh, C,
                                  kelim, int(transpose), stream),
                 "tpt_qr_apply")
    qr_apply.launches += 1


qr_apply.launches = 0
