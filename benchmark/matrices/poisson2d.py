"""5-point 2D Laplacian with per-direction coefficients.

Frozen copy of ``chip_smoke.py::grid_spd`` (the g x g grid, Dirichlet
boundary, ``sp.diags`` layout; the SpMV leg of BENCH_r05) without its
shift, widened to per-direction coefficients: the coupling along x and
y is -cx and -cy and the diagonal 2 (cx + cy).  With cx = cy = 1 this
is the matrix that PETSc's KSP tutorial ex2 assembles (4 on the
diagonal, -1 to each neighbour).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ._csc import csc_arrays


def build(params: dict, rng: np.random.Generator) -> tuple:
    """(m, n, indptr, indices, data) of the grid operator of
    ``params["grid"]`` and ``params["coef"]`` (cx, cy); the values are
    fixed by the configuration, so ``rng`` is not drawn from."""
    g = int(params["grid"])
    cx, cy = (float(c) for c in params["coef"])
    n = g * g
    ex = -cx * np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0.0
    ey = -cy * np.ones(n - g)
    d = 2.0 * (cx + cy) * np.ones(n)
    return csc_arrays(sp.diags([d, ex, ex, ey, ey], [0, 1, -1, g, -g],
                               format="csc"))
