"""Peaks of one NVIDIA H100 SXM and the byte and operation counts of the
tile kernels, frozen for the roofline readers.

Frozen copy of ``chip_smoke.py``'s ``HBM_BPS``, ``FP32_FLOPS`` and
``bound_ms`` (NVIDIA's data sheet, dense float32 outside the tensor
cores, at the 700 W limit), and of the byte and operation counts of its
``chol_shape`` and ``trsm_shape``, with the needed bytes only: each
input byte read once, each output byte written once, and a lower
triangular factor counted by its lower triangle (``chol_tiles`` reads
only the lower triangle of its input and only the lower triangle of its
output is L).  Every slot of a launch counts: the shapes do not say
which slots are padding.
"""

from __future__ import annotations

HBM_BPS = 3.35e12       # device memory bytes/s
FP32_FLOPS = 67e12      # float32 operations/s outside the tensor cores
F32 = 4                 # bytes


def bound_s(nbytes: float, flops: float) -> float:
    """Least time on the card: bytes over the memory rate or operations
    over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS)


def chol_tiles_counts(tiles: tuple) -> tuple:
    """(bytes, operations) of ``chol_tiles`` on (nt, B, B) tiles."""
    nt, B, _ = tiles
    tri = B * (B + 1) // 2
    return 2 * F32 * nt * tri, nt * B ** 3 / 3


def trsm_tiles_batched_counts(X: tuple) -> tuple:
    """(bytes, operations) of ``trsm_tiles_batched`` with X (nt, R, W):
    the lower triangle of each slot's W x W factor, X read, Y written."""
    nt, R, W = X
    return F32 * (nt * W * (W + 1) // 2 + 2 * nt * R * W), nt * R * W * W


def spmv_counts(m: int, n: int, nnz: int) -> tuple:
    """(bytes, operations) of one y = A x in float32, whatever the
    format: each stored value of A and each entry of x read once, each
    entry of y written once; a multiply and an add per value.  A DIA
    kernel also reads the zeros its bands hold, so it never reads less."""
    return F32 * (nnz + n + m), 2 * nnz
