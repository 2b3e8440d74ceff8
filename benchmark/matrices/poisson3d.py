"""7-point 3D Laplacian with per-direction coefficients.

Frozen copy of ``chip_smoke.py::grid_spd_3d`` (the g^3 grid, Dirichlet
boundary, ``sp.diags`` layout) without its shift, widened to HYPRE
``ij``'s ``-laplacian -c cx cy cz``: the coupling along x, y and z is
-cx, -cy, -cz and the diagonal 2 (cx + cy + cz).  HYPRE's default
coefficients are 1.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ._csc import csc_arrays


def build(params: dict, rng: np.random.Generator) -> tuple:
    """(m, n, indptr, indices, data) of the grid operator of
    ``params["grid"]`` and ``params["coef"]`` (cx, cy, cz); the values
    are fixed by the configuration, so ``rng`` is not drawn from."""
    g = int(params["grid"])
    cx, cy, cz = (float(c) for c in params["coef"])
    n = g * g * g
    ex = -cx * np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0.0
    ey = -cy * np.ones(n - g)
    ey[(np.arange(g, n) // g) % g == 0] = 0.0
    ez = -cz * np.ones(n - g * g)
    d = 2.0 * (cx + cy + cz) * np.ones(n)
    A = sp.diags([d, ex, ex, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    return csc_arrays(A)
