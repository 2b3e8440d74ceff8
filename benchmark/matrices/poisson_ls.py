"""Tikhonov-regularized least squares [L; alpha I]: L the 5-point 2D
Laplacian on the g x g grid with a Dirichlet boundary (4 on the
diagonal, -1 to each neighbour), stacked over alpha times the identity;
m = 2 g^2 rows, n = g^2 columns.

Frozen copy of ``chip_smoke.py::poisson_ls`` (the matrix of
``bench/bench_qr.py``, the ``sp.diags`` layout), with alpha taken from
the configuration.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ._csc import csc_arrays


def build(params: dict, rng: np.random.Generator) -> tuple:
    """(m, n, indptr, indices, data) of the problem of ``params``
    ("grid", "alpha"); the values are fixed by the configuration, so
    ``rng`` is not drawn from."""
    g = int(params["grid"])
    n = g * g
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0.0
    ey = -np.ones(n - g)
    L = sp.diags([4.0 * np.ones(n), ex, ex, ey, ey], [0, 1, -1, g, -g],
                 format="csc")
    return csc_arrays(sp.vstack([L, float(params["alpha"]) * sp.eye(n)],
                                format="csc"))
