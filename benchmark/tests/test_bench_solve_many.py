"""The block solve cell (``poisson3d_g48.solve_many``) on the CPU: its runs
at g=8, a solve that skips refinement read as not correct, the first
sweep read through the public entry where the wrapper keeps none, the
seeded blocks of mixed scale, the sweep's counts by hand, and the four
readers of its own: a number on a recorded block solve in a synthetic trace,
nothing where the window holds no block solve's root (the parent's
program) or the program has no recorder."""

import os
import time

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import ROOT, TINY, copy_root

from benchmark import harness
from benchmark.matrices import poisson3d
from benchmark.metrics import _program, _roofline, _solve_roofline
from benchmark.ops import solve_many as op
from benchmark.reference import solve_many as ref
from benchmark.trace import Trace
from tpusparse_torch.core.matrix import CSCMatrix
from tpusparse_torch.device.refine_many import refine_many
from tpusparse_torch.device.superscan import SuperscanCholesky
from tpusparse_torch.utils import profiling

CELL = "poisson3d_g48.solve_many"
SEED = 2 ** 33 + 5
EVENTS_A_SPAN = 3       # synthetic device events started inside a span
EVENT_NS = 5
SWEEP = ("superscan.solve.forward", "superscan.solve.backward")
K = 4


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> str:
    """The benchmark with the cell's own configuration cut as its
    matrix's is in ``TINY``."""
    return copy_root(str(tmp_path_factory.mktemp("tiny_many")),
                     {**TINY, "poisson3d_g48_k32": TINY["poisson3d_g48"]})


def _matrix(g: int) -> tuple:
    return poisson3d.build({"grid": g, "coef": [1.0, 1.0, 1.0]}, None)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_block_solve_cell_runs_on_the_cpu(tiny_root, trace):
    r = harness.run_cell(tiny_root, CELL, SEED, 0.5, bool(trace),
                         device="cpu")
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"grade", "sweep_grade"}
    assert r["checks"]["grade"]["value"] <= 1e-14
    assert 0 < r["checks"]["sweep_grade"]["value"] < 1e-6
    # without a card only the planner's host timing reads in a traced run
    want = {"setup_s", "solve_ms", "peak_mib"} if not trace else {"plan_s"}
    assert set(r["metrics"]) == want


def _unrefined(self, B, refine_iters=3):
    """The first f32 sweep, returned as the block solve."""
    return self._solve_f32_many(np.asarray(B, np.float64))


def test_an_unrefined_block_solve_is_not_correct(tiny_root, monkeypatch):
    monkeypatch.setattr(SuperscanCholesky, "solve_many", _unrefined)
    r = harness.run_cell(tiny_root, CELL, SEED, 0.3, False, device="cpu")
    assert r["correct"] is False
    assert r["checks"]["grade"]["value"] > 1e-14
    assert r["checks"]["sweep_grade"]["value"] <= \
        r["checks"]["sweep_grade"]["limit"]


def test_the_first_sweep_is_read_through_the_entry_where_unwrapped(
        tiny_root, monkeypatch):
    """A program whose sweep has another name: the op reads each first
    sweep by ``solve_many(B, refine_iters=0)`` after the window."""
    sweep = SuperscanCholesky._solve_f32_many
    monkeypatch.delattr(SuperscanCholesky, "_solve_f32_many")
    monkeypatch.setattr(SuperscanCholesky, "_sweep_many", sweep,
                        raising=False)
    monkeypatch.setattr(
        SuperscanCholesky, "solve_many",
        lambda self, B, refine_iters=3: refine_many(
            self.A, self._sweep_many, np.asarray(B, np.float64),
            refine_iters))
    r = harness.run_cell(tiny_root, CELL, SEED, 0.3, False, device="cpu")
    assert r["correct"] is True
    assert 0 < r["checks"]["sweep_grade"]["value"] < 1e-6


def test_blocks_are_seeded_and_of_mixed_scale(tiny_root):
    """Two requests of one run differ; the same seed gives the same
    first block, another seed another."""
    spec = harness.Spec(tiny_root, CELL)
    cpu = harness.torch.device("cpu")
    ctx, other = (harness.Context(spec, s, cpu, False, False)
                  for s in (SEED, SEED + 1))
    rng = ctx.rng(1)
    a, b = op._block(ctx, rng), op._block(ctx, rng)
    assert a.shape == (ctx.A[1], spec.traffic["k"]) == (512, 32)
    assert np.array_equal(a, op._block(ctx, ctx.rng(1)))
    assert not np.array_equal(a, b)
    assert not np.array_equal(a, op._block(other, other.rng(1)))
    scale = np.abs(a).max(axis=0)
    assert scale.max() / scale.min() > 1e3
    assert (scale < 1e3).all() and (scale > 0.9e-3).all()


def test_the_reference_holds_each_column_to_its_own_grade():
    """A column 10^-6 of the others, off by 1e-9 of its size, fails by
    its own grade; the block's joint grade would not see it."""
    A = _matrix(3)
    D = sp.csc_matrix((A[4], A[3], A[2]), shape=A[:2]).toarray()
    B = np.random.default_rng(1).uniform(-1, 1, (A[1], 3))
    B[:, 1] *= 1e-6
    X = np.linalg.solve(D, B)
    assert ref.grade(A, X, B) < 1e-15
    X[:, 1] *= 1 + 1e-9
    g = ref.grades(A, X, B)
    assert g[1] > 1e-14 > max(g[0], g[2])
    assert ref.grade(A, X[:, :2], B) == np.inf
    X[0, 2] = np.nan
    assert ref.grade(A, X, B) == np.inf


def test_sweep_counts_by_hand():
    """Bytes 2 (4 lnz + 2 * 4 n k), operations 4 lnz k; lnz of the g=3
    plan is the count of the dense Cholesky factor's nonzeros."""
    assert _solve_roofline.sweep_counts(10, 3, 2) == (2 * (40 + 48), 80)
    A = _matrix(3)
    F = SuperscanCholesky(CSCMatrix(*A), order=1, device="cpu")
    p = np.asarray(F.plan.perm)
    D = sp.csc_matrix((A[4], A[3], A[2]), shape=A[:2]).toarray()
    L = np.linalg.cholesky(D[np.ix_(p, p)])
    assert F.plan.lnz == np.count_nonzero(L) == 146
    nbytes, flops = _solve_roofline.sweep_counts(F.plan.lnz, 27, 32)
    assert (nbytes, flops) == (2 * (4 * 146 + 8 * 27 * 32), 4 * 146 * 32)
    assert _roofline.bound_s(nbytes, flops) == max(nbytes / 3.35e12,
                                                   flops / 67e12)


# ------------------------------------------------------------- readers
@pytest.fixture(scope="module")
def solver():
    F = SuperscanCholesky(CSCMatrix(*_matrix(TINY["poisson3d_g48"])),
                          order=1, device="cpu")
    assert F.factor()
    return F


def _window(run) -> tuple:
    """(t0, t1, spans) of ``run()`` recorded, the only spans kept."""
    profiling.clear()
    with profiling.recording() as rec:
        t0 = time.time_ns()
        run()
        t1 = time.time_ns()
    return t0, t1, rec


def _block_solve(F):
    """A single solve, then a block solve."""
    B = np.random.default_rng(2).uniform(-1, 1, (F.A.n, K))

    def run():
        F.solve(B[:, 0])
        F.solve_many(B)
    return _window(run)


def _parent(F):
    """A block solve as the parent's program runs it: no root span."""
    B = np.random.default_rng(2).uniform(-1, 1, (F.A.n, K))
    return _window(lambda: refine_many(F.A, F._solve_f32_many, B, 3))


def _trace(t0, t1, rec, facts=None) -> Trace:
    """EVENTS_A_SPAN device events of EVENT_NS starting inside each
    forward and backward span (of every solve) and one outside them."""
    events = [("outside", t0, t0 + 1)]
    for s in rec:
        if s.name in SWEEP:
            step = max((s.end - s.start) // (EVENTS_A_SPAN + 1), EVENT_NS)
            events += [("kernel", s.start + i * step,
                        s.start + i * step + EVENT_NS)
                       for i in range(EVENTS_A_SPAN)]
    return Trace(cell="tiny", t0=t0, t1=t1, requests=1, events=events,
                 traced_device=True, facts=facts or {})


def _mine(rec):
    root, = [s for s in rec if s.name == "superscan.solve_many"]
    return root, [s for s in rec if s.root == root.index]


def _self_ns(s, rec) -> int:
    return (s.end - s.start) - sum(k.end - k.start for k in rec
                                   if k.parent == s.index)


def _want(name, rec, F):
    root, mine = _mine(rec)
    sweeps = root.counts["sweeps"]
    events = EVENTS_A_SPAN * 2 * sweeps
    fb = [s for s in mine if s.name in SWEEP]
    if name == "many_issue_us":
        return sum(s.end - s.start for s in fb) / events / 1e3
    if name == "many_sweeps":
        return float(sweeps)
    if name == "many_residual_ms":
        return sum(_self_ns(s, rec) for s in mine
                   if s.name == "refine_many.residual") / 1e6
    if name == "many_sweep_roofline":
        bound = _roofline.bound_s(*_solve_roofline.sweep_counts(
            F.plan.lnz, F.A.n, K))
        return 100.0 * sweeps * bound / (events * EVENT_NS / 1e9)


READERS = ("many_issue_us", "many_sweep_roofline", "many_sweeps",
           "many_residual_ms")


def _reader(name: str):
    return harness._load(os.path.join(ROOT, "benchmark", "metrics",
                                      name + ".py"),
                         f"benchmark.metrics.{name}")


def _facts(F) -> dict:
    return {"n": F.A.n, "k": K, "lnz": int(F.plan.lnz)}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_block_solve(solver, name):
    t0, t1, rec = _block_solve(solver)
    got = _reader(name).read(_trace(t0, t1, rec, _facts(solver)))
    assert got is not None and got > 0
    assert got == pytest.approx(_want(name, rec, solver), rel=1e-12)
    # a window that holds none of the spans reads nothing
    assert _reader(name).read(_trace(t1 + 1, t1 + 10 ** 9, rec,
                                     _facts(solver))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_of_the_parents_program(solver, name):
    """The parent's block solve records its sweeps as roots of their own
    and no ``superscan.solve_many``: every reader reads None."""
    t0, t1, rec = _parent(solver)
    assert {s.name for s in rec if s.parent == -1} == {
        "superscan.solve.sweep", "refine_many.residual"}
    assert _reader(name).read(_trace(t0, t1, rec, _facts(solver))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_recorder(solver, monkeypatch,
                                                    name):
    t0, t1, rec = _block_solve(solver)
    monkeypatch.delattr(profiling, "spans")
    assert _reader(name).read(_trace(t0, t1, rec, _facts(solver))) is None


def test_the_roofline_reads_nothing_without_the_facts(solver):
    t0, t1, rec = _block_solve(solver)
    assert _program.spans(_trace(t0, t1, rec), root="superscan.solve_many")
    assert _reader("many_sweep_roofline").read(_trace(t0, t1, rec)) is None
