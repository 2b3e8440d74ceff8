"""Plain CSC arrays of a scipy matrix, columns sorted (as
``chip_smoke.py::_csc`` hands them to the program)."""

from __future__ import annotations

import numpy as np


def csc_arrays(S) -> tuple:
    """(m, n, indptr int64, indices int64, data float64)."""
    S = S.tocsc()
    S.sort_indices()
    return (S.shape[0], S.shape[1], S.indptr.astype(np.int64),
            S.indices.astype(np.int64), S.data.astype(np.float64))
