"""Judges y = A x, and the SpMV control.

``rel_error``: max |y - A x| / max |A x|, A x in float64 from the CSC
arrays; inf where y is not finite or of the wrong shape, or A x is 0 (in
a sound chain x never vanishes: the carry keeps it near the top of A's
spectrum).

``Tf32Spmv`` is the reference put in the program's place one precision
below the configuration's float32: the values of A and of every x are
rounded to TF32 (10 stored mantissa bits, to nearest, ties to even), as
a tensor core rounds its inputs, and the products are summed in float32
(a product of two TF32 values is exact in float32).  Plain PyTorch: a
CSR product on the device that runs the cell.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import csc


def rel_error(A: tuple, x: np.ndarray, y: np.ndarray) -> float:
    y = np.asarray(y, np.float64)
    if y.shape != (A[0],) or not np.isfinite(y).all():
        return float("inf")
    ref = csc.matvec(A, x)
    scale = np.abs(ref).max()
    if not scale > 0:
        return float("inf")     # the chain vanished: a sound one does not
    return float(np.abs(y - ref).max() / scale)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (finite inputs)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Tf32Spmv:
    """y = A x with A and x rounded to TF32, summed in float32."""

    def __init__(self, A: tuple, device):
        m, n, indptr, indices, data = A
        cols = csc.columns(indptr)
        order = np.lexsort((cols, indices))          # CSC -> CSR
        crow = np.concatenate([[0], np.cumsum(np.bincount(indices,
                                                          minlength=m))])
        vals = round_tf32(torch.as_tensor(data[order], dtype=torch.float32))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # "beta" notices
            self.A = torch.sparse_csr_tensor(
                torch.as_tensor(crow), torch.as_tensor(cols[order]), vals,
                size=(m, n)).to(device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return (self.A @ round_tf32(x)[:, None])[:, 0]

