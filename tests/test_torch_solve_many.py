"""Block solves on the port's normal path, on the CPU: ``cholsol`` with an
(n, k) B and ``SuperscanCholesky.solve_many`` against a dense f64
``torch.linalg.solve`` on columns of mixed scale, each column to its own
grade; the columns against k single solves; ``refine_many``'s stop,
which reads each column; and the spans of a block solve, which the
single solve's readers do not read."""

import os
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpusparse_torch
from benchmark import harness
from benchmark.metrics import _program
from benchmark.trace import Trace
from tpusparse_torch.core import CSCMatrix
from tpusparse_torch.device import superscan
from tpusparse_torch.device.refine_many import refine_many
from tpusparse_torch.utils.profiling import recording

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 6


def _grid3d(g: int) -> CSCMatrix:
    """The 7-point 3D Laplacian on g^3 (6 on the diagonal)."""
    n = g ** 3
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % g == 0] = 0
    ey = -np.ones(n - g)
    ey[((np.arange(g, n) // g) % g) == 0] = 0
    ez = -np.ones(n - g * g)
    S = sp.diags([6.0 * np.ones(n), ex, ex, ey, ey, ez, ez],
                 [0, 1, -1, g, -g, g * g, -g * g], format="csc")
    S.sort_indices()
    return CSCMatrix(n, n, S.indptr, S.indices, S.data)


def _dense(A: CSCMatrix) -> np.ndarray:
    return sp.csc_matrix((A.data, A.indices, A.indptr),
                         shape=(A.m, A.n)).toarray()


def _block(n: int, k: int, seed: int) -> np.ndarray:
    """U(-1, 1) entries, column j times 10^u_j, u_j from U(-3, 3)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, k)) * 10.0 ** rng.uniform(-3, 3, k)


def _grades(D: np.ndarray, X: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Each column's ||A x_j - b_j||_inf / (||A||_1 ||x_j||_inf +
    ||b_j||_inf), in f64."""
    R = D @ X - B
    return np.abs(R).max(axis=0) / (np.abs(D).sum(axis=0).max()
                                    * np.abs(X).max(axis=0)
                                    + np.abs(B).max(axis=0))


@pytest.fixture(scope="module")
def factored():
    F = superscan.SuperscanCholesky(_grid3d(6), order=1, device="cpu")
    assert F.factor()
    return F


def _solve_many(A, B):
    F = superscan.SuperscanCholesky(A, order=1, device="cpu")
    assert F.factor()
    return F.solve_many(B)


def _cholsol(engine):
    def run(A, B):
        ok, X = tpusparse_torch.cholsol(1, A, B, engine=engine, device="cpu")
        assert ok
        return X
    return run


ENTRIES = {"solve_many": _solve_many,
           **{f"cholsol_{e}": _cholsol(e)
              for e in ("superscan", "supernodal", "tiled")}}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_block_solve_matches_a_dense_solve(entry):
    """Every column within 1e-10 of torch.linalg.solve in f64 (relative
    to the column's own size; kappa ~ 30 here) and at its own grade,
    though the column scales span six decades."""
    A = _grid3d(5)
    B = _block(A.n, K, 11)
    X = ENTRIES[entry](A, B)
    D = _dense(A)
    want = torch.linalg.solve(torch.from_numpy(D),
                              torch.from_numpy(B)).numpy()
    assert X.shape == B.shape
    err = np.abs(X - want).max(axis=0) / np.abs(want).max(axis=0)
    assert err.max() <= 1e-10
    assert _grades(D, X, B).max() <= 1e-14


def test_block_columns_match_single_solves(factored):
    F = factored
    B = _block(F.A.n, K, 12)
    X = F.solve_many(B)
    for j in range(K):
        x = F.solve(B[:, j])
        assert np.abs(X[:, j] - x).max() <= 1e-12 * np.abs(x).max()


@pytest.mark.parametrize("B", ["short", "three_way", "scalar"])
def test_cholsol_refuses_a_b_of_another_shape(B):
    A = _grid3d(3)
    b = {"short": np.ones((A.n - 1, 2)), "three_way": np.ones((A.n, 2, 2)),
         "scalar": np.float64(1.0)}[B]
    assert tpusparse_torch.cholsol(1, A, b, engine="superscan",
                                   device="cpu") == (False, None)


def test_cholsol_keeps_a_vector_a_vector():
    A = _grid3d(4)
    b = np.linspace(-1, 1, A.n)
    ok, x = tpusparse_torch.cholsol(1, A, b, engine="superscan",
                                    device="cpu")
    ok1, X = tpusparse_torch.cholsol(1, A, b[:, None], engine="superscan",
                                     device="cpu")
    assert ok and ok1 and x.shape == (A.n,) and X.shape == (A.n, 1)
    assert np.abs(X[:, 0] - x).max() <= 1e-12 * np.abs(x).max()


# --------------------------------------------------------- refine_many
SWEEPS_TO_MEET = 5


def _stub(D: np.ndarray, slow: int, off: float):
    """An f32 solve that is exact in f64 on every column but ``slow``,
    whose solution it returns (1 + ``off``) times too large: each sweep
    leaves that column ``off`` times the error it had.  Counts its
    calls."""
    calls = []

    def solve(R):
        calls.append(1)
        X = np.linalg.solve(D, R)
        X[:, slow] *= 1.0 + off
        return X
    return solve, calls


@pytest.mark.parametrize("iters,sweeps", [(2, 3), (10, SWEEPS_TO_MEET)])
def test_refine_many_sweeps_until_each_column_meets_its_grade(iters,
                                                               sweeps):
    """Column 1 is 10^-12 of the others and the stub leaves 1e-3 of its
    error a sweep: the block's joint test (max|R| against the block's
    largest X and B) is met after the first sweep, but column 1's own
    grade (about 3e-4, 3e-7, ...) only after the fifth.  With ``iters``
    2 the loop stops at the cap, column 1 short of its grade."""
    A = _grid3d(3)
    D = _dense(A)
    B = np.random.default_rng(3).uniform(-1, 1, (A.n, 4))
    B[:, 1] *= 1e-12
    solve, calls = _stub(D, 1, 1e-3)
    X = refine_many(A, solve, B, iters=iters)
    assert len(calls) == sweeps
    g = _grades(D, X, B)
    assert g[[0, 2, 3]].max() < 1e-15
    assert (g[1] < 1e-14) == (sweeps == SWEEPS_TO_MEET)
    # the joint test of the JAX package: met after the first sweep
    X1 = np.linalg.solve(D, B)
    X1[:, 1] *= 1.001
    R1 = B - D @ X1
    assert np.abs(R1).max() < 1e-14 * (np.abs(D).sum(axis=0).max()
                                       * np.abs(X1).max() + np.abs(B).max())


def test_a_zero_column_counts_as_met():
    A = _grid3d(3)
    D = _dense(A)
    B = np.random.default_rng(4).uniform(-1, 1, (A.n, 3))
    B[:, 2] = 0.0
    solve, calls = _stub(D, 0, 0.0)
    X = refine_many(A, solve, B, iters=3)
    assert len(calls) == 1 and not X[:, 2].any()


# --------------------------------------------------------------- spans
@pytest.mark.parametrize("iters", [0, 3])
def test_block_solve_spans(factored, iters):
    """``superscan.solve_many`` counts the ``sweeps`` (the calls of
    ``_solve_f32_many``, counted by a wrapper as the benchmark's op wraps
    it) and the ``cols`` k; a ``refine_many.residual`` span a refinement
    step and each sweep's spans lie under it."""
    F = factored
    calls = []
    sweep = type(F)._solve_f32_many

    def wrapped(B, *a, **kw):
        calls.append(1)
        return sweep(F, B, *a, **kw)
    F._solve_f32_many = wrapped
    try:
        with recording() as rec:
            F.solve_many(_block(F.A.n, K, iters), refine_iters=iters)
    finally:
        del F._solve_f32_many
    root, = [s for s in rec if s.parent == -1]
    assert root.name == "superscan.solve_many"
    assert root.counts == {"sweeps": len(calls), "cols": K}
    assert len(calls) >= 1
    by = {s.index: s for s in rec}
    kids = [s.name for s in rec if s.parent == root.index]
    assert kids.count("superscan.solve.sweep") == len(calls)
    # a residual a refinement step: the last one met, or the cap reached
    assert kids.count("refine_many.residual") in (len(calls) - 1,
                                                  len(calls))
    assert kids.count("refine_many.residual") <= iters
    assert set(kids) <= {"superscan.solve.sweep",
                         "refine_many.residual"}
    for s in rec:
        if s.name in ("superscan.solve.forward", "superscan.solve.backward"):
            assert by[s.parent].name == "superscan.solve.sweep"
            assert by[s.parent].parent == root.index
        assert s.root == root.index


def _reader(name: str):
    return harness._load(os.path.join(ROOT, "benchmark", "metrics",
                                      name + ".py"),
                         f"benchmark.metrics.{name}")


SOLVE_READERS = ("solve_sweeps", "solve_pairs")


def test_the_solve_readers_read_no_block_solve(factored):
    """A window that holds a single solve and then a block solve reads as
    the single solve alone: the readers of ``poisson3d_g48.solve`` filter
    by the root ``superscan.solve``, which a block solve's sweeps do not
    have."""
    F = factored
    b = np.linspace(-1, 1, F.A.n)
    with recording():
        t0 = time.time_ns()
        F.solve(b)
        tm = time.time_ns()
        F.solve_many(_block(F.A.n, K, 5))
        t1 = time.time_ns()
    alone, both = (Trace(cell="tiny", t0=t0, t1=t, requests=1,
                         events=[("kernel", t0, t0 + 1)],
                         traced_device=True) for t in (tm, t1))
    mine = _program.spans(alone, root="superscan.solve")
    assert mine and [s.index for s in mine] == [
        s.index for s in _program.spans(both, root="superscan.solve")]
    assert not _program.spans(alone, root="superscan.solve_many")
    assert _program.spans(both, root="superscan.solve_many")
    for name in SOLVE_READERS:
        got = _reader(name).read(both)
        assert got is not None and got == _reader(name).read(alone)
